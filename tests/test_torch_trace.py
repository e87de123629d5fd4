"""Spans and counters of the port's sweeps (``convexadam_torch/utils/trace.py``)
on the CPU, at tiny sizes.

* Off (no profiler): a sweep's record is empty and a span is the shared
  null context.
* On (under ``torch.profiler``): a semantic stage-1 sweep with the device
  HD95 engine and a paired stage-1 sweep hold their preparation, each
  case's convex stage with its ``convex.*`` layers, evaluation, HD95 with
  its ``hd95.*`` layers and fetch; parents enclose their children and hand
  them their case; each span lasts as long as its profiler range (in one
  of two traced runs, so that the host's scheduling cannot part them); no
  ``sweep.*`` span but ``sweep.prep`` encloses another ``sweep.*`` one.
* Every result is bit-equal with tracing on and off, and two traced runs
  count alike.
* Each case's coupled argmin counts 12 plain folds here (6 rounds, two
  directions) and 12 kernel launches on a card.
* Host waits: a sync warning counts under the innermost open span, other
  warnings pass on, and nothing counts without a profiler.  Torch's sync
  debug mode warns on a card only, so the sweeps' own waits are checked
  there (marked ``card``, skipped here), by span: run them on a card with
  ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py -m card``.
"""

import dataclasses
import gc
import warnings

import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter
from torch.profiler import ProfilerActivity, profile

from convexadam_torch.selfconfig import engine, paired
from convexadam_torch.selfconfig.settings import Stage1PairedSetting, Stage1Setting
from convexadam_torch.utils import trace

torch.set_num_threads(2)

SEMANTIC = [Stage1Setting(nn_mult=10, grid_sp=3, disp_hw=2),
            Stage1Setting(nn_mult=5, grid_sp=4, disp_hw=1)]
PAIRED = [Stage1PairedSetting(mind_r=1, mind_d=2, grid_sp=3, disp_hw=2),
          Stage1PairedSetting(mind_r=2, mind_d=1, grid_sp=4, disp_hw=1)]
PAIRS = [(0, 1), (1, 2)]
SPACING = np.array([1.5, 1.5, 1.5], np.float32)
CONVEX_LAYERS = {"convex.features", "convex.pool", "convex.cost_volume", "convex.coupled",
                 "convex.ic", "convex.upsample"}
HD95_LAYERS = {"hd95.surface_buffers", "hd95.searches", "hd95.overflow"}


def _labels(n=24, K=3, seed=0):
    """K label volumes n^3 of two nested boxes shifted per subject;
    predictions are the truth rolled by one voxel."""
    rng = np.random.default_rng(seed)
    segs = np.zeros((K, n, n, n), np.int32)
    for k in range(K):
        o = rng.integers(-2, 3, 3)
        segs[k, 5 + o[0]:18 + o[0], 5 + o[1]:18 + o[1], 5 + o[2]:18 + o[2]] = 1
        segs[k, 9 + o[0]:14 + o[0], 9 + o[1]:14 + o[1], 9 + o[2]:14 + o[2]] = 2
    return np.roll(segs, 1, axis=1), segs


def _volumes(n=24, kpts=(15, 11), seed=1):
    """Smooth random volumes, their copies rolled by (2, -1, 1) and per pair
    ``kpts[i]`` keypoints with their moved positions."""
    rng = np.random.default_rng(seed)
    shift = (2, -1, 1)
    vols, movs, kfs, kms = [], [], [], []
    for nk in kpts:
        vol = uniform_filter(rng.standard_normal((n, n, n)).astype(np.float32), 2) * 100
        vols.append(vol)
        movs.append(np.roll(vol, shift, axis=(0, 1, 2)))
        kf = rng.random((nk, 3)).astype(np.float32) * (n - 12) + 6
        kfs.append(kf)
        kms.append(kf + np.array(shift, np.float32))
    return np.stack(vols), np.stack(movs), kfs, kms


def _semantic(device="cpu"):
    preds, segs = _labels()
    return engine.run_stage1_sweep(preds, segs, PAIRS, SEMANTIC, num_labels=2,
                                   hd95_mode="device", device=device)


def _paired(device="cpu"):
    vols, movs, kfs, kms = _volumes()
    return paired.run_stage1_paired_sweep(vols, movs, kfs, kms, PAIRED, spacing=SPACING,
                                          device=device)


def _traced(run):
    """``run()`` under the profiler: its result and the profiler's ranges
    by name, each name's in order of start."""
    # a collection between a span's clock and its range's would part the two
    gc.collect()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # a process's first range takes about a millisecond longer to open
            with torch.profiler.record_function("first range"):
                pass
            res = run()
    finally:
        gc.enable()
    ranges: dict = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        ranges.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    return res, ranges


@pytest.fixture(scope="module", params=["semantic", "paired"])
def runs(request):
    """A sweep's untraced run and two traced runs."""
    run = _semantic if request.param == "semantic" else _paired
    off = run()
    (on, ranges), (again, ranges_again) = _traced(run), _traced(run)
    return request.param, off, on, (ranges, ranges_again), again


def _children(spans, k):
    return [c for c in spans if c.parent == k]


def test_off_the_record_is_empty_and_spans_open_nothing(runs):
    _, off, *_ = runs
    assert off.spans == [] and off.counters == {}
    assert trace.span("sweep.prep") is trace._NULL and trace._records == []
    trace.count("kernel_loads")  # no record open: nothing to count into
    assert trace._records == []


def test_results_are_bit_equal_with_tracing_on_and_off(runs):
    kind, off, on, _, again = runs
    for key in ("dice", "jstd", "hd95", "rank", "best"):
        np.testing.assert_array_equal(getattr(on, key), getattr(off, key))
    for key, value in off.cases.items():
        np.testing.assert_array_equal(on.cases[key], value)
    assert on.counters == again.counters
    assert [s.name for s in on.spans] == [s.name for s in again.spans]


def test_fields_are_bit_equal_with_tracing_on_and_off():
    preds, _ = _labels()
    vols, movs, _, _ = _volumes()

    def fields():
        return (engine.convex_field_semantic(preds[0], preds[1], 10.0, 3, 3, 2, device="cpu"),
                engine.convex_field_mind(vols[0], movs[0], 1, 2, 3, 2, device="cpu"))

    off = fields()
    with profile(activities=[ProfilerActivity.CPU]):
        on = fields()
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_the_record_holds_each_layer_of_each_case(runs):
    kind, _, on, _, _ = runs
    spans = on.spans
    names = {s.name for s in spans}
    prep = {"sweep.prep", "sweep.prep.robust30", "sweep.prep.upload"}
    if kind == "semantic":
        prep |= {"sweep.prep.label_groups", "sweep.prep.hd95_sides"}
    assert prep <= names
    cases = [(s, i) for s in range(2) for i in range(2)]
    for name in ("sweep.convex", "sweep.evaluate") + (("sweep.hd95",) if kind == "semantic"
                                                      else ()):
        top = [(k, s) for k, s in enumerate(spans) if s.name == name]
        assert sorted(s.case for _, s in top) == cases, name
        for k, s in top:
            assert s.parent == -1
            below = {c.name for c in _children(spans, k)}
            if name == "sweep.convex":
                assert below == CONVEX_LAYERS, below
            elif name == "sweep.hd95":
                assert below == HD95_LAYERS, below
    fetch = sorted(s.case for s in spans if s.name == "sweep.fetch")
    assert fetch == (cases if kind == "semantic" else [(0, None), (1, None)])
    assert all(s.stream_ms is None for s in spans)  # no card


def test_coupled_argmin_counts_its_plain_folds(runs):
    """Off the card every coupled argmin takes the plain fold: 6 rounds in
    each of the two directions inverse consistency runs, 12 a case."""
    kind, _, on, _, _ = runs
    settings = SEMANTIC if kind == "semantic" else PAIRED
    assert on.counters["coupled_argmin.plain"] == 12 * len(settings) * len(PAIRS)
    assert "coupled_argmin.kernel" not in on.counters


def test_box_passes_count_their_plain_calls_inside_the_cost_volume(runs):
    """Off the card each direction's box passes are one plain call, spanned
    as ``convex.box`` inside its ``convex.cost_volume``: two a case."""
    kind, _, on, _, _ = runs
    n = 2 * len(SEMANTIC if kind == "semantic" else PAIRED) * len(PAIRS)
    assert on.counters["box_passes.plain"] == n and "box_passes.kernel" not in on.counters
    boxes = [s for s in on.spans if s.name == "convex.box"]
    assert len(boxes) == n
    assert all(on.spans[s.parent].name == "convex.cost_volume" for s in boxes)


def test_parents_enclose_their_children_and_hand_down_their_case(runs):
    _, _, on, _, _ = runs
    for k, s in enumerate(on.spans):
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = on.spans[s.parent]
            assert s.parent < k and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.case == p.case
        if s.name.startswith("convex."):
            assert s.parent >= 0


def _gaps(res, ranges) -> dict:
    """Per span name, each span's distance (ms) from its profiler range."""
    by_name: dict = {}
    for s in res.spans:
        by_name.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
    for name, ms in by_name.items():
        assert len(ranges[name]) == len(ms), name
    return {name: np.abs(np.array(ms) - ranges[name]) for name, ms in by_name.items()}


def test_each_span_lasts_as_long_as_its_profiler_range(runs):
    """Within 1 ms, in one of the two traced runs: the host may take the
    test's thread away between a span's clock and its range's boundary (up
    to a time slice, on a loaded machine), which seldom strikes one span in
    both runs."""
    _, _, on, (ranges, ranges_again), again = runs
    first, second = _gaps(on, ranges), _gaps(again, ranges_again)
    for name, gap in first.items():
        assert np.all(np.minimum(gap, second[name]) <= 1.0), (name, gap, second[name])


def test_no_sweep_span_but_prep_holds_another(runs):
    """Device time of a ``sweep.*`` range goes to the innermost one: a
    ``sweep.*`` span inside ``sweep.convex`` or ``sweep.hd95`` would take
    the benchmark's ``convex_dev_ms`` or ``score_dev_ms`` from it."""
    _, _, on, _, _ = runs
    for s in on.spans:
        if not s.name.startswith("sweep."):
            continue
        p = s.parent
        while p >= 0:
            up = on.spans[p].name
            assert not up.startswith("sweep.") or up == "sweep.prep", (s.name, up)
            p = on.spans[p].parent


def _sync_warning():
    warnings.warn(trace.SYNC_MESSAGE + " (Triggered internally)", UserWarning)


def test_sync_warnings_count_as_host_waits_by_innermost_span():
    with pytest.warns(RuntimeWarning, match="passes on") as seen:
        with profile(activities=[ProfilerActivity.CPU]), trace.recording() as rec:
            _sync_warning()
            with trace.span("sweep.fetch", (0, 1)):
                for _ in range(2):
                    _sync_warning()
                with trace.span("convex.ic"):
                    _sync_warning()
            warnings.warn("passes on", RuntimeWarning)
    assert rec.counters == {"host_waits.unspanned": 1, "host_waits.sweep.fetch": 2,
                            "host_waits.convex.ic": 1}
    assert [str(w.message) for w in seen] == ["passes on"]
    with pytest.warns(UserWarning, match=trace.SYNC_MESSAGE):
        with trace.recording() as rec:  # no profiler: nothing counts
            with trace.span("sweep.fetch"):
                _sync_warning()
    assert rec.counters == {} and rec.spans == []


def test_off_the_card_no_stream_is_timed_and_no_wait_counted():
    with profile(activities=[ProfilerActivity.CPU]), trace.recording() as rec:
        trace.on_device(torch.device("cpu"))
        with trace.span("sweep.convex", (0, 0)):
            torch.ones(8).sum()
    assert rec.stream_device is None and rec.sync_mode is None
    assert rec.spans[0].stream_ms is None and rec.counters == {}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_waits(run) -> "tuple[dict, object]":
    """A warm call of ``run`` and two traced ones, which count alike: the
    second's host waits by site (a span of its record, or the setting's
    sync) and its result."""
    run()
    torch.cuda.synchronize()
    (res, _), (again, _) = _traced(run), _traced(run)
    assert res.counters == again.counters
    assert all(s.stream_ms is not None and s.stream_ms >= 0 for s in res.spans)
    waits = {k[len("host_waits."):]: v for k, v in res.counters.items()
             if k.startswith("host_waits.")}
    assert set(waits) <= {s.name for s in res.spans} | {"setting_sync"}, waits
    return waits, res


@pytest.mark.card
def test_paired_host_waits_are_the_enumerated_sites():
    """Per (setting, pair): two MIND permutations (an index list copied to
    the card), two displacement meshes, the IC scale and the keypoint
    scale; per setting the sync before its clock and the fetch; per call
    the uploads of four keypoint batches, two volume stacks and the
    spacing."""
    dev = _card()
    waits, _ = _card_waits(lambda: _paired(dev))
    S, P = len(PAIRED), 2
    assert waits == {"convex.features": 2 * S * P, "sweep.convex": 2 * S * P,
                     "convex.ic": S * P, "sweep.evaluate": S * P, "sweep.fetch": S,
                     "setting_sync": S, "sweep.prep.upload": 7}


@pytest.mark.card
def test_semantic_counters_read_the_sites():
    """The semantic sweep's sites that do not depend on the data: the sync
    a setting, five host copies a case's fetch, two uploads, two meshes and
    the IC scale a case, five waits a pair's prepared fixed side (its label
    counts and outer tables); 34 a case in all (with the label counts and
    tables of Dice and HD95), unless a case was re-scored."""
    dev = _card()
    waits, res = _card_waits(lambda: _semantic(dev))
    S, P = len(SEMANTIC), len(PAIRS)
    assert waits["setting_sync"] == S and waits["sweep.fetch"] == 5 * S * P
    assert waits["sweep.prep.upload"] == 2 and waits["sweep.prep.hd95_sides"] == 5 * P
    assert waits["sweep.convex"] == 2 * S * P and waits["convex.ic"] == S * P
    if res.rescored == 0:
        assert sum(waits.values()) == S + 34 * S * P + 5 * P + 2, waits
    assert res.counters["kernel_builds"] == 0 and "kernel_loads" not in res.counters


@pytest.mark.card
@pytest.mark.parametrize("kind", ["semantic", "paired"])
def test_coupled_argmin_counts_its_kernel_launches(kind):
    """On the card every coupled argmin is one kernel launch, 12 a case
    (6 rounds, 2 directions), and none takes the plain fold."""
    dev = _card()
    _, res = _card_waits(lambda: (_semantic if kind == "semantic" else _paired)(dev))
    settings = SEMANTIC if kind == "semantic" else PAIRED
    assert res.counters["coupled_argmin.kernel"] == 12 * len(settings) * len(PAIRS)
    assert "coupled_argmin.plain" not in res.counters


@pytest.mark.card
@pytest.mark.parametrize("kind", ["semantic", "paired"])
def test_box_passes_count_their_kernel_launches(kind):
    """On the card each direction's box passes are one kernel launch, two a
    case, each timed by its ``convex.box`` span; none takes the plain path."""
    dev = _card()
    _, res = _card_waits(lambda: (_semantic if kind == "semantic" else _paired)(dev))
    n = 2 * len(SEMANTIC if kind == "semantic" else PAIRED) * len(PAIRS)
    assert res.counters["box_passes.kernel"] == n and "box_passes.plain" not in res.counters
    boxes = [s for s in res.spans if s.name == "convex.box"]
    assert len(boxes) == n and all(s.stream_ms > 0 for s in boxes)


def test_a_span_outside_a_sweep_opens_its_range_only():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("convex.pool"):
            torch.ones(8).sum()
    assert any(e.name == "convex.pool" for e in prof.events())
    assert trace._records == []


def test_a_record_nested_in_another_keeps_its_own():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.recording() as outer:
            with trace.span("sweep.prep", (0, None)):
                with trace.recording() as inner:
                    with trace.span("sweep.convex", (0, 1)):
                        trace.count("kernel_loads")
                trace.count("kernel_builds", 2)
    assert [s.name for s in outer.spans] == ["sweep.prep"]
    assert [(s.name, s.parent, s.case) for s in inner.spans] == [("sweep.convex", -1, (0, 1))]
    assert outer.counters == {"kernel_builds": 2} and inner.counters == {"kernel_loads": 1}
    assert dataclasses.asdict(outer.spans[0])["case"] == (0, None)
