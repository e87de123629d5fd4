"""Core numerics of the port: smoothing, warping, features, cost volume,
coupled convex optimisation and the Adam instance optimisation."""
