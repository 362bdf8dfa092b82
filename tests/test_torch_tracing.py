"""The port's spans and counters (``fpc_diffrend_tpu_torch.utils.profiling``
``span``, ``count``, ``recording``) inside the fit step and the view, on
the CPU at a tiny size.

Off, they enter no ``record_function``, launch no counter op and leave the
step's result as it is; on, each step gives each of its spans once, nested
as the layers are (on the mip path the pyramid and K8 with its LOD
inside ``raster.fwd``, K9 inside ``raster.bwd``), each span a ``user_annotation``
of a profiler trace, ``fit.batch_samples`` counts each step's B, and the
bin counters agree with ``raster_stats`` and ``entry_count``, the global
list's with the batch's pooled oversized triangles.
"""

import json
import threading

import numpy as np
import pytest
import torch

from fpc_diffrend_tpu_torch import profile_forward
from fpc_diffrend_tpu_torch.fit import loop
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as trc
from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked
from fpc_diffrend_tpu_torch.utils import profiling
from fpc_diffrend_tpu_torch.workload import build_workload

from _torch_scenes import clip_batch, quads_scene

H, W, GRID, BATCH = 48, 128, 5, 2

# span -> the span it lies in on the kernel route
FIT_PARENT = {"fit.step": "fit.dispatch", "fit.sample": "fit.dispatch",
              "fit.forward": "fit.step", "fit.backward": "fit.step",
              "fit.optimizer": "fit.step", "model.prologue": "fit.forward",
              "raster.bin": "fit.forward", "raster.fwd": "fit.forward",
              "raster.composite": "fit.forward", "fit.loss": "fit.forward",
              "K11 bin_place": "raster.bin", "raster.bwd": "fit.backward"}
# the mip path's own spans
MIP_PARENT = {"raster.pyramid": "raster.fwd",
              "raster.mip_fwd": "raster.fwd",
              "raster.mip_bwd": "raster.bwd"}
VIEW_PARENT = {"model.prologue": "view.render", "raster.bin": "view.render",
               "raster.fwd": "view.render",
               "raster.composite": "view.render",
               "K11 bin_place": "raster.bin"}
SPANS = (set(FIT_PARENT) | set(FIT_PARENT.values()) | set(VIEW_PARENT)
         | {"view.render", "fit.callbacks"})


def workload(mip=False):
    return build_workload(H, W, grid=GRID, batch=BATCH,
                          tex_size=64 if mip else 16, mip=mip, device="cpu")


def batches(wl, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    sampler = loop.sample_batches(wl["config"], wl["n_frames"], g)
    out = []
    for _ in range(n):
        cam, frame = next(sampler)
        out.append(loop.Batch(cam, frame, loop.decode_refs(wl["frames_u8"],
                                                           cam, frame)))
    return out


def two_steps(wl):
    for batch in batches(wl, 2):
        loop.train_step(wl["config"], wl["scene"], wl["state"], batch)
    return {k: v.detach().clone() for k, v in wl["state"].params.items()}


def names_in(events):
    return {e.get("name") for e in events} & SPANS


def profiled(fn, path):
    """The Chrome trace events of fn() under a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_off_enters_nothing_and_changes_nothing(tmp_path):
    """(a) Off: no span, no K11 range, no counter op under the profiler,
    no log; the parameters bit-equal to two steps recorded."""
    wl = workload()
    got = {}
    events = profiled(lambda: got.update(two_steps(wl)), tmp_path / "t.json")
    assert names_in(events) == set()
    assert profiling._ACTIVE is None
    profiling.count("bin.kept", lambda: pytest.fail("counted while off"))
    wl_on = workload()
    with profiling.recording() as log:
        want = two_steps(wl_on)
    assert log.spans and profiling._ACTIVE is None
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mip", [False, True])
def test_each_step_gives_each_span_once(mip):
    """(b) On: per step each fit span once, nested as the layers are,
    inside its parent's interval, with the step's request id; on the mip
    path also the pyramid and K8 with its LOD in ``raster.fwd`` and K9 in
    ``raster.bwd``. ``fit.batch_samples`` counts B a step."""
    wl = workload(mip)
    g = torch.Generator().manual_seed(3)
    step0 = wl["state"].step
    with profiling.recording() as log:
        loop.train_steps(wl["config"], wl["scene"], wl["state"],
                         wl["frames_u8"], g, 2, wl["n_frames"])
    spans = log.spans
    parents = dict(FIT_PARENT, **(MIP_PARENT if mip else {}))
    assert [s.name for s in spans].count("fit.dispatch") == 1
    for step in (step0, step0 + 1):
        mine = [s for s in spans if s.request == step]
        assert sorted(s.name for s in mine) == sorted(
            set(parents) - {"fit.sample"})
    for s in spans:
        assert 0 < s.end_ns and s.start_ns <= s.end_ns
        if s.name == "fit.dispatch":
            assert s.parent is None
            continue
        parent = spans[s.parent]
        assert parent.name == parents[s.name], s.name
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        if s.name not in ("fit.sample", "fit.step"):
            assert s.request == parent.request
    assert [s.name for s in spans].count("fit.sample") == 2
    assert log.counters["fit.batch_samples"] == 2 * BATCH
    assert log.counters["fit.eager_steps"] == 2


def test_view_gives_its_spans_once_a_view():
    wl = workload()
    with profiling.recording() as log:
        for cam in (0, 1):
            loop.render_sample(wl["config"], wl["scene"], wl["params"], cam,
                               0)
    views = [i for i, s in enumerate(log.spans) if s.name == "view.render"]
    assert len(views) == 2
    assert len({log.spans[i].request for i in views}) == 2
    for i in views:
        kids = [s for s in log.spans if s.request == log.spans[i].request
                and s.name != "view.render"]
        assert sorted(s.name for s in kids) == sorted(VIEW_PARENT)
        for s in kids:
            assert log.spans[s.parent].name == VIEW_PARENT[s.name]


def test_a_thread_without_spans_works_for_the_recording_thread():
    """A span on a thread with none open (autograd's device thread on
    CUDA) takes the innermost open span of the recording's thread as its
    parent, and its request."""
    with profiling.recording() as log:
        with profiling.span("fit.step", request=7):
            with profiling.span("fit.backward"):
                def worker():
                    with profiling.span("raster.bwd"):
                        with profiling.span("inner"):
                            pass
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=10)
    assert not t.is_alive()
    by = {s.name: s for s in log.spans}
    assert log.spans[by["raster.bwd"].parent].name == "fit.backward"
    assert by["raster.bwd"].request == 7
    assert by["raster.bwd"].thread != by["fit.backward"].thread
    assert log.spans[by["inner"].parent].name == "raster.bwd"


def test_profiled_recording_holds_every_span(tmp_path):
    """(c) Every span of a recorded fit and view is a user_annotation of
    the profiler's Chrome trace."""
    wl = workload()

    def run():
        with profiling.recording():
            loop.run_fit(wl["config"], wl["scene"], wl["frames_u8"],
                         wl["n_frames"], callbacks=[lambda *a: None],
                         state=wl["state"], n_steps=1)
            loop.render_sample(wl["config"], wl["scene"], wl["params"], 0, 0)

    events = profiled(run, tmp_path / "t.json")
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert SPANS <= annotated


def test_bin_counters_follow_the_steps_samples():
    """(d) live pairs = raster_stats' n_valid_pairs over each step's
    samples; capacity = entry_count a step; kept = the live pairs the cap
    keeps; K5 reads no u, v, z plane in either step's backward: every
    stacked pixel on ``k5.uvz_skipped``."""
    wl = workload()
    config, scene = wl["config"], wl["scene"]
    T = scene.faces.shape[0]
    P = trc.entry_count(BATCH, T, config.pair_cap)
    live, big = [], []
    with profiling.recording() as log:
        for batch in batches(wl, 2, seed=5):
            with torch.no_grad():
                pc, _ = loop.sample_clip_positions(
                    config, scene, wl["state"].params, batch.cam_idx,
                    batch.frame_idx)
            stats = trc.raster_stats(pc, scene.faces, H, W)
            live.append(int(stats["n_valid_pairs"].sum()))
            big.append(int((stats["n_global"]
                            + stats["global_overflow"]).sum()))
            loop.train_step(config, scene, wl["state"], batch)
    assert config.pair_cap > 0 and sum(live) > 0
    ph, pw = trc.pad_resolution(H, W)
    assert log.counters == {
        "bin.live_pairs": sum(live), "bin.capacity": 2 * P,
        "bin.kept": sum(min(n, P) for n in live),
        "bin.global_live": sum(big),
        "bin.global_kept": sum(min(n, trc.MAX_GLOBAL) for n in big),
        "k5.uvz_skipped": 2 * BATCH * ph * pw}


@pytest.mark.parametrize("cap", [0, 128])
def test_bin_counters_show_what_the_cap_drops(rng, cap):
    verts, faces, uv, fn = quads_scene(rng, n_quads=40)
    B, h, w = 3, 24, 128
    pc = torch.as_tensor(clip_batch(verts * 1.6, rng, B))
    faces_t, fn_t = torch.as_tensor(faces), torch.as_tensor(fn)
    with profiling.recording() as log:
        _, _, bins = bin_stacked(pc, faces_t, torch.as_tensor(uv), faces_t,
                                 fn_t, (h, w), cap)
    stats = trc.raster_stats(pc, faces_t, h, w)
    live = int(stats["n_valid_pairs"].sum())
    big = int((stats["n_global"] + stats["global_overflow"]).sum())
    P = trc.entry_count(B, faces.shape[0], cap)
    assert log.counters == {"bin.live_pairs": live, "bin.capacity": P,
                            "bin.kept": min(live, P),
                            "bin.global_live": big,
                            "bin.global_kept": min(big, trc.MAX_GLOBAL)}
    assert log.counters["bin.kept"] == int(bins.bin_start[-1])
    if cap:
        assert live > P          # the cap drops live - kept pairs


def test_global_counters_pool_the_batch():
    """``bin.global_live`` counts the oversized triangles of every sample of
    the batch, pooled into the one global list; ``bin.global_kept`` the
    rows the list of ``MAX_GLOBAL`` keeps, which ``Bins.n_global`` holds:
    400 a sample, B = 3, so 1,200 live and 1,024 kept."""
    B, n, h, w = 3, 400, 64, 256
    x = np.arange(n) % (w - 2) + 0.5
    xs = 2 * np.stack([x, x + 1.0, x], 1) / w - 1.0     # NDC, full height
    ys = np.tile([-0.99, -0.99, 0.99], (n, 1))
    zs = np.tile(np.linspace(-0.5, 0.5, n)[:, None], (1, 3))
    clip = np.stack([xs, ys, zs, np.ones_like(xs)], -1).reshape(-1, 4)
    pc = torch.as_tensor(np.broadcast_to(clip, (B,) + clip.shape).copy(),
                         dtype=torch.float32)
    faces = torch.arange(3 * n, dtype=torch.int32).reshape(n, 3)
    with profiling.recording() as log:
        _, _, bins = bin_stacked(pc, faces, torch.zeros((3 * n, 2)), faces,
                                 torch.full((n, 3), -1), (h, w))
    stats = trc.raster_stats(pc, faces, h, w)
    assert stats["n_global"].tolist() == [n] * B
    assert log.counters["bin.global_live"] == B * n
    assert log.counters["bin.global_kept"] == trc.MAX_GLOBAL
    assert int(bins.n_global[0]) == trc.MAX_GLOBAL


def test_counters_and_totals():
    assert profiling._ACTIVE is None
    with profiling.recording() as log:
        profiling.count("n", 2)
        profiling.count("n", lambda: 3)
        profiling.count("d", torch.tensor(4, dtype=torch.int32))
        profiling.count("d", lambda: torch.tensor([1, 2]))
        with profiling.recording() as inner:
            assert inner is log
        assert profiling._ACTIVE is log
    assert profiling._ACTIVE is None
    assert log.counters == {"n": 5, "d": 7}
    log.spans = [profiling.Span("a", 0, 10_000, 1, None, None),
                 profiling.Span("b", 2_000, 4_000, 1, 0, None),
                 profiling.Span("c", 3_000, 6_000, 2, 0, None),
                 profiling.Span("b", 7_000, 8_000, 1, 0, None)]
    got = log.totals()
    assert got["a"][0] == 1 and got["b"][0] == 2
    np.testing.assert_allclose(got["a"][1:], (10e-6, 5e-6))
    np.testing.assert_allclose(got["b"][1:], (3e-6, 3e-6))


def test_span_device_time_from_a_trace(tmp_path):
    """``profile_forward.span_device_us``: each kernel counts in every span
    whose interval holds its launch, on any thread."""
    def x(cat, name, ts, dur, corr=None, tid=1):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [x("user_annotation", "fit.step", 0, 100),
              x("user_annotation", "fit.backward", 50, 40),
              x("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
              x("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=2, tid=9),
              x("cuda_runtime", "cudaLaunchKernel", 120, 1, corr=3),
              x("kernel", "k1", 20, 5, corr=1),
              x("kernel", "k2", 70, 7, corr=2),
              x("kernel", "k3", 130, 11, corr=3)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profile_forward.span_device_us(str(path)) == {
        "fit.step": 12, "fit.backward": 7}
