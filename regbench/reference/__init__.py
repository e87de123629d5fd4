"""The benchmark's plain reference of the convex stage and its scores.

Plain PyTorch and NumPy, written from the published method (convexAdam's
``convex_adam_utils.py`` and its self-configuring scripts
``convex_run_withconfig.py`` and ``convex_run_paired_mind.py``).  It imports
nothing of the program under test: it is given the same inputs and works
the fields and the scores out again.  Every function takes the dtype of the
convex stage, so that the same code computed in bfloat16 serves as the
precision control (``regbench/control.py``).
"""
