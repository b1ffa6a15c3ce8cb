"""The CUDA graph of `rasterize`'s eval path (ops/raster_graph.py).

On the CPU: the graph's key is the same across camera poses and scene
values, differs for each field and module switch that shapes eval work
and not for the train-only switch; every tensor argument gets a buffer;
every camera field is copied, keyed or one the eval path does not read;
hooks, grad, a mesh axis and CPU inputs take the eager path; the routing
(eager, capture, replay, keys in turns, `eager()`, `release()`) with the
capture and replay stood in for; a replay's advance of the host counters.
On the card (marked `cuda`): replay against eager bit for bit over 20
poses on both binning paths and two tilings and on the street scene's
slot layout, returned tensors that the next call leaves alone, the kernel
launch counters against eager and against a profiler trace's kernel
records, a new key freeing the old graph, and another scene tensor of the
same shape.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_raster_graph.py
"""
import dataclasses
import inspect
import math
import weakref

import numpy as np
import pytest
import torch

from gaussianrpg_tpu_torch.ops import (binning, blend, fields, gather,
                                       raster_graph, scan)
from gaussianrpg_tpu_torch.ops import rasterize as R
from gaussianrpg_tpu_torch.parallel.collectives import Axis
from gaussianrpg_tpu_torch.render.camera import Camera, make_camera
from gaussianrpg_tpu_torch.tools._timing import kernel_trace

from .torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)

W, H = 128, 96


def _camera(device, pose=0, width=W, height=H, fov=60.0):
    """A camera looking down +z, turned by `pose` degrees about y and
    moved sideways with it."""
    a = math.radians(pose)
    c2w = np.eye(4)
    c2w[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                   [-math.sin(a), 0, math.cos(a)]]
    c2w[0, 3] = 0.05 * pose
    w2c = np.linalg.inv(c2w)
    fovx = math.radians(fov)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    return make_camera(R=w2c[:3, :3].T, T=w2c[:3, 3], K=None, width=width,
                       height=height, fovx=fovx, fovy=fovy, device=device)


def _scene(device, n=2000, seed=3):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(1, 8, n)], -1)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    host = dict(means3d=means, opacities=rng.uniform(0.05, 0.95, n),
                colors=rng.uniform(0, 1, (n, 3)),
                scales=np.exp(rng.uniform(-3.5, -1.0, (n, 3))), rotations=q)
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in host.items()}


def _call(**kw):
    """`rasterize`'s keyword arguments with its defaults, `device` left
    out: what `raster_graph.key` and `raster_graph.engages` take."""
    b = inspect.signature(R.rasterize).bind(**kw)
    b.apply_defaults()
    args = dict(b.arguments)
    args.pop("device")
    return args


def _base(device="cpu", **over):
    s = _scene(device)
    kw = dict(s, camera=_camera(device),
              bg_color=torch.zeros(3, device=device), capacity=1 << 16)
    kw.update(over)
    return _call(**kw)


# -- the key --------------------------------------------------------------

def test_key_is_the_same_across_poses_and_scene_values():
    a = _base()
    b = _base(camera=_camera("cpu", pose=7),
              **{k: v + 1 for k, v in _scene("cpu", seed=9).items()},
              bg_color=torch.ones(3))
    assert raster_graph.key(a) == raster_graph.key(b)


def _cam(c, **kw):
    return dict(camera=c["camera"].replace(**kw))


SEM = torch.zeros(2000, 3)
KEYED = {
    "n": lambda c: _scene("cpu", n=1999),
    "shs": lambda c: dict(colors=None, shs=torch.zeros(2000, 4, 3)),
    "no_semantics": lambda c: dict(semantics=None),
    "semantic_width": lambda c: dict(semantics=torch.zeros(2000, 5)),
    "cov3d_precomp": lambda c: dict(cov3d_precomp=torch.zeros(2000, 6)),
    "active_mask": lambda c: dict(active_mask=torch.ones(2000,
                                                         dtype=torch.bool)),
    "no_scales": lambda c: dict(scales=None),
    "no_rotations": lambda c: dict(rotations=None),
    "opacity_shape": lambda c: dict(opacities=c["opacities"][:, None]),
    "dtype": lambda c: dict(colors=c["colors"].double()),
    "sh_degree": lambda c: dict(sh_degree=1),
    "scale_modifier": lambda c: dict(scale_modifier=0.5),
    "capacity": lambda c: dict(capacity=1 << 17),
    "tile_x": lambda c: dict(tile_x=32),
    "tile_y": lambda c: dict(tile_y=32),
    "tight_rect": lambda c: dict(tight_rect=False),
    "sub_chunks": lambda c: dict(sub_chunks=2),
    "tail_cap": lambda c: dict(tail_cap=8192),
    "big_cap": lambda c: dict(big_cap=1024),
    "emit_k": lambda c: dict(emit_k=2),
    "width": lambda c: _cam(c, width=160),
    "height": lambda c: _cam(c, height=80),
    "tan_fovx": lambda c: _cam(c, tan_fovx=0.5),
    "tan_fovy": lambda c: _cam(c, tan_fovy=0.5),
    "lim_tan_fovx": lambda c: _cam(c, lim_tan_fovx=0.7),
    "lim_tan_fovy": lambda c: _cam(c, lim_tan_fovy=0.7),
    "full_width": lambda c: _cam(c, full_width=256),
    "full_height": lambda c: _cam(c, full_height=192),
}


@pytest.mark.parametrize("field", sorted(KEYED))
def test_key_differs_for_each_keyed_field(field):
    a = _base(semantics=SEM)
    b = dict(a, **KEYED[field](a))
    assert raster_graph.key(a) != raster_graph.key(b)


@pytest.mark.parametrize("module,name,value", [
    (binning, "EMIT_PAIRS", False), (binning, "EMIT_K", 3),
    (binning, "SUB_CHUNKS", 2)])
def test_key_differs_for_each_module_switch(module, name, value,
                                            monkeypatch):
    call = _base()
    before = raster_graph.key(call)
    monkeypatch.setattr(module, name, value)
    assert raster_graph.key(call) != before


def test_key_ignores_the_train_only_switch(monkeypatch):
    """`rasterize.DERIVE_GM` shapes train calls only, and those never
    engage the graph: flipping it leaves an eval call's key as it was."""
    call = _base()
    before = raster_graph.key(call)
    monkeypatch.setattr(R, "DERIVE_GM", not R.DERIVE_GM)
    assert raster_graph.key(call) == before


def test_every_tensor_argument_gets_a_buffer():
    """Every argument of `rasterize` that may be a tensor, given one, and
    each camera matrix the path reads get a buffer of their own, of the
    same shape and dtype, from the function the capture makes them with."""
    tensor_args = {n for n, p in inspect.signature(
        R.rasterize).parameters.items() if "Tensor" in str(p.annotation)}
    call = _base()
    call.update({n: torch.zeros(2000, 2) for n in tensor_args
                 if call[n] is None})
    assert len(tensor_args) >= 10
    bufs, cam_bufs = raster_graph._buffers(call)
    assert set(bufs) == tensor_args
    assert set(cam_bufs) == set(raster_graph.CAMERA)
    pairs = [(b, call[n]) for n, b in bufs.items()] + [
        (b, getattr(call["camera"], n)) for n, b in cam_bufs.items()]
    for b, t in pairs:
        assert (b.shape, b.dtype) == (t.shape, t.dtype)
        assert b.data_ptr() != t.data_ptr()


# the camera's fields the path does not read: neither copied nor keyed
UNREAD = {"K", "ego_pose", "extrinsic", "timestamp", "frame", "image_id",
          "cam_id", "meta"}


def test_every_camera_field_is_copied_keyed_or_unread():
    """A field added to `Camera` fails here until it is put in
    `raster_graph.CAMERA`, `CAMERA_KEY` or the unread set above."""
    copied, keyed = set(raster_graph.CAMERA), set(raster_graph.CAMERA_KEY)
    assert not (copied & keyed or copied & UNREAD or keyed & UNREAD)
    fields = {f.name for f in dataclasses.fields(Camera)}
    assert fields == copied | keyed | UNREAD


@pytest.mark.parametrize("color_from", ["colors", "shs"])
def test_the_eval_path_reads_no_unread_camera_field(color_from):
    """The eager eval path, run with a camera that records what is read
    of it, reads none of the fields that a replay neither copies nor
    keys, with colours given and from spherical harmonics."""
    read = set()
    fields = {f.name for f in dataclasses.fields(Camera)}

    class Recording(Camera):
        def __getattribute__(self, name):
            if name in fields:
                read.add(name)
            return object.__getattribute__(self, name)

    cam = _camera("cpu")
    call = _base(camera=Recording(**{n: getattr(cam, n) for n in fields}))
    if color_from == "shs":
        call.update(colors=None, sh_degree=1,
                    shs=torch.rand(2000, 4, 3, generator=torch.Generator()
                                   .manual_seed(0)))
    read.clear()
    out = R.rasterize(**call, device="cpu")
    assert out.color.shape == (3, H, W)
    assert read and not read & UNREAD
    assert read <= set(raster_graph.CAMERA) | set(raster_graph.CAMERA_KEY)


# -- who engages -----------------------------------------------------------

CUDA = torch.device("cuda")


@pytest.mark.parametrize("case", ["means2d_offset", "absgrad_sink", "grad",
                                  "camera_grad", "model_axis", "cpu"])
def test_training_mesh_and_cpu_calls_take_the_eager_path(case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    n = 2000
    over = {"means2d_offset": dict(means2d_offset=torch.zeros(n, 2)),
            "absgrad_sink": dict(absgrad_sink=torch.zeros(n)),
            "model_axis": dict(model_axis=Axis("model", None, 1, 0))}.get(
                case, {})
    call = _base(**over)
    if case == "grad":
        call["means3d"].requires_grad_(True)
    if case == "camera_grad":
        call["camera"].viewmatrix.requires_grad_(True)
    dev = torch.device("cpu") if case == "cpu" else CUDA
    assert not raster_graph.engages(call, dev)
    if case != "model_axis":          # a mesh axis needs its process group
        before = dict(R.graph_counts)
        out = R.rasterize(device="cpu", **call)
        assert out.color.shape == (3, H, W)
        assert R.graph_counts == dict(before, eager=before["eager"] + 1)


@pytest.mark.parametrize("grad_mode,capturing,engages", [
    (False, False, True), (True, False, False), (False, True, False)])
def test_the_gate_on_grad_mode_and_a_capturing_stream(grad_mode, capturing,
                                                      engages, monkeypatch):
    """An input that needs grad engages under no_grad; a stream already
    capturing never does (the card's own answer stood in for)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    call = _base()
    call["opacities"].requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        assert raster_graph.engages(call, CUDA) == engages


# -- the routing, with the capture and the replay stood in for -------------

class _Routing:
    """`raster_graph.run` with the gate, the key, the capture and the
    replay stood in for: a call is its key."""

    def __init__(self, monkeypatch):
        self.log = []
        monkeypatch.setattr(raster_graph, "engages", lambda call, dev: True)
        monkeypatch.setattr(raster_graph, "key", lambda call: call["key"])
        monkeypatch.setattr(raster_graph, "_capture", self.capture)
        monkeypatch.setattr(raster_graph, "_replay", self.replay)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
        raster_graph.release()

    def capture(self, key, call, fn):
        self.log.append(("capture", key))
        return raster_graph._Held(key, None, {}, {}, (), (0, 0))

    def replay(self, held, call):
        self.log.append(("replay", held.key))
        return "replayed"

    def run(self, key):
        return raster_graph.run(dict(key=key), CUDA, lambda **c: "eager")


def test_routing_eager_then_capture_then_replay(monkeypatch):
    r = _Routing(monkeypatch)
    c0 = dict(R.graph_counts)
    try:
        assert [r.run("a") for _ in range(3)] == ["eager", "replayed",
                                                  "replayed"]
        assert r.log == [("capture", "a"), ("replay", "a"), ("replay", "a")]
    finally:
        raster_graph.release()
    assert R.graph_counts == dict(c0, eager=c0["eager"] + 1)


def test_routing_keys_in_turns_stay_eager(monkeypatch):
    r = _Routing(monkeypatch)
    try:
        assert [r.run(k) for k in "ababab"] == ["eager"] * 6
        assert r.log == []
        assert [r.run(k) for k in "aa"] == ["eager", "replayed"]
        assert r.log == [("capture", "a"), ("replay", "a")]
        # the held graph stays while another key passes through eagerly
        assert r.run("b") == "eager"
        assert r.run("a") == "replayed"
        assert r.run("b") == "eager"
        assert len(r.log) == 3
    finally:
        raster_graph.release()


def test_routing_eager_calls_leave_the_chain(monkeypatch):
    """Calls inside `eager()` run eagerly and neither capture nor break
    two consecutive calls of one key."""
    r = _Routing(monkeypatch)
    try:
        assert r.run("a") == "eager"
        with R.eager():
            assert [r.run(k) for k in "ab"] == ["eager", "eager"]
        assert r.run("a") == "replayed"
        with R.eager():
            assert r.run("a") == "eager"
        assert r.log == [("capture", "a"), ("replay", "a")]
    finally:
        raster_graph.release()


def test_routing_release_drops_the_graph_and_the_last_key(monkeypatch):
    r = _Routing(monkeypatch)
    try:
        assert [r.run("a") for _ in range(2)] == ["eager", "replayed"]
        raster_graph.release()
        assert raster_graph._held is None
        assert [r.run("a") for _ in range(2)] == ["eager", "replayed"]
        r.run("b")
        raster_graph.release()
        assert r.run("b") == "eager"
        assert r.log == [("capture", "a"), ("replay", "a")] * 2
    finally:
        raster_graph.release()


class _Graph:
    def replay(self):
        pass


def test_replay_advances_the_host_counters_by_the_capture():
    """A replay adds what its capture ran to kernel B's and A's launch
    counters, A's elements, the row gather's launches and the primitive
    stage kernel's launches."""
    z = torch.zeros(1, 4, 4)
    out = R.RasterOut(color=z.expand(3, 4, 4), depth=z, alpha=z,
                      semantic=torch.zeros(0, 4, 4),
                      radii=torch.zeros(2, dtype=torch.int32),
                      means2d=torch.zeros(2, 2), overflow=torch.tensor(False),
                      n_pairs=torch.tensor(3))
    by = (1, 2, 3, 4, 5)
    held = raster_graph._Held("k", _Graph(), {}, {}, out, by)

    def counters():
        return (blend.launches, scan.launches, scan.elements,
                gather.launches, fields.launches)

    assert len(raster_graph.COUNTERS) == len(by)
    before = counters()
    try:
        got = raster_graph._replay(held, {"camera": None})
        assert counters() == tuple(b + d for b, d in zip(before, by))
    finally:
        raster_graph._advance(tuple(-d for d in by))
    assert counters() == before
    assert torch.equal(got.color, out.color) and got.radii is not out.radii


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    raster_graph.release()
    yield torch.device("cuda")
    raster_graph.release()


def _render(scene, cam, bg, tile, **kw):
    return R.rasterize(camera=cam, bg_color=bg, capacity=1 << 16,
                       tile_x=tile[0], tile_y=tile[1], device="cuda",
                       **scene, **kw)


def _fields(out):
    return [out.color, out.depth, out.alpha, out.semantic, out.radii,
            out.means2d, out.overflow, out.n_pairs]


def _assert_equal(a, b):
    for x, y in zip(_fields(a), _fields(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


PATHS = [((64, 32), True), ((16, 16), True), ((16, 16), False),
         ((64, 32), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile,emit", PATHS)
def test_replay_equals_eager_over_20_poses(cuda, tile, emit, monkeypatch):
    monkeypatch.setattr(binning, "EMIT_PAIRS", emit)
    scene = _scene(cuda)
    scene["semantics"] = torch.rand(2000, 3, device=cuda,
                                    generator=torch.Generator(
                                        cuda).manual_seed(1))
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    c0 = dict(R.graph_counts)
    with torch.no_grad():
        for pose in range(20):
            cam = _camera(cuda, pose=pose)
            got = _render(scene, cam, bg, tile)
            with R.eager():
                ref = _render(scene, cam, bg, tile)
            _assert_equal(got, ref)
            assert int(ref.n_pairs) > 0 and not bool(ref.overflow)
    c1 = R.graph_counts
    assert c1["captures"] - c0["captures"] == 1
    assert c1["replays"] - c0["replays"] == 19
    assert c1["eager"] - c0["eager"] == 21      # the first call, 20 refs


@pytest.mark.cuda
@pytest.mark.parametrize("tile,emit", PATHS[:3])
def test_returned_tensors_survive_the_next_call(cuda, tile, emit,
                                                monkeypatch):
    monkeypatch.setattr(binning, "EMIT_PAIRS", emit)
    scene = _scene(cuda)
    bg = torch.zeros(3, device=cuda)
    with torch.no_grad():
        outs = [_render(scene, _camera(cuda, pose=p), bg, tile)
                for p in range(5)]
        kept = [[t.clone() for t in _fields(o)] for o in outs]
        _render(scene, _camera(cuda, pose=9), bg, tile)
    assert R.graph_counts["replays"] > 0
    for o, k in zip(outs, kept):
        for x, y in zip(_fields(o), k):
            assert torch.equal(x, y)
    assert not torch.equal(outs[3].color, outs[4].color)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,emit", PATHS[1:3])
def test_launch_counters_advance_as_eager(cuda, tile, emit, monkeypatch):
    monkeypatch.setattr(binning, "EMIT_PAIRS", emit)
    scene = _scene(cuda)
    bg = torch.zeros(3, device=cuda)
    cam = _camera(cuda, pose=2)

    def deltas(fn):
        b, s = blend.launches, scan.launches
        fn()
        return blend.launches - b, scan.launches - s

    trace = []

    with torch.no_grad():
        with R.eager():
            eager = deltas(lambda: _render(scene, cam, bg, tile))
        first = deltas(lambda: _render(scene, cam, bg, tile))
        capture = deltas(lambda: _render(scene, cam, bg, tile))
        r0 = R.graph_counts["replays"]
        replay = deltas(lambda: _render(scene, cam, bg, tile))
        # the kernels the card ran in replays, from a profiler trace's
        # records (1 + 2 x 3 calls: one before it, a warm-up step, a kept
        # step), against what the counters say
        traced = deltas(lambda: trace.extend(kernel_trace(
            lambda: _render(scene, cam, bg, tile), reps=3)))
    assert R.graph_counts["replays"] == r0 + 1 + 7
    assert eager == first == replay and eager[0] == 1 and eager[1] >= 2
    # the capture call warms up and replays: two runs of the path
    assert capture == (2 * eager[0], 2 * eager[1])
    assert traced == (7 * eager[0], 7 * eager[1])
    records = [sum(k["launches_per_call"] for k in trace
                   if name in k["name"])
               for name in ("blend_fwd", "cummax_lookback")]
    assert records == list(eager)


@pytest.mark.cuda
def test_a_new_key_recaptures_and_frees_the_old_graph(cuda):
    scene = _scene(cuda)
    bg = torch.zeros(3, device=cuda)
    c0 = R.graph_counts["captures"]
    with torch.no_grad():
        for _ in range(3):
            _render(scene, _camera(cuda), bg, (16, 16))
        old = weakref.ref(raster_graph._held.graph)
        key = raster_graph._held.key
        for _ in range(3):
            out = _render(scene, _camera(cuda, width=160), bg, (16, 16))
        assert out.color.shape == (3, H, 160)
    assert R.graph_counts["captures"] == c0 + 2
    assert raster_graph._held.key != key and old() is None


@pytest.mark.cuda
@pytest.mark.parametrize("fresh", ["colors", "means3d", "bg_color"])
def test_another_scene_tensor_changes_the_output_as_eager(cuda, fresh):
    scene = _scene(cuda)
    bg = torch.zeros(3, device=cuda)
    cam = _camera(cuda, pose=3)
    other = _scene(cuda, seed=11)
    with torch.no_grad():
        for _ in range(3):
            _render(scene, cam, bg, (16, 16))
        c0 = R.graph_counts["captures"]
        if fresh == "bg_color":
            changed, bg2 = scene, torch.ones(3, device=cuda)
        else:
            changed, bg2 = dict(scene, **{fresh: other[fresh]}), bg
        got = [_render(changed, cam, bg2, (16, 16)) for _ in range(2)]
        with R.eager():
            ref = _render(changed, cam, bg2, (16, 16))
            before = _render(scene, cam, bg, (16, 16))
    for g in got:
        _assert_equal(g, ref)
    assert not torch.equal(ref.color, before.color)
    # every input is copied in on every call: the graph stays
    assert R.graph_counts["captures"] == c0


@pytest.mark.cuda
def test_replay_equals_eager_on_the_street_slot_layout(cuda):
    """The street scene's slot layout (4,325,376 slots, 665,536 of them
    active, the rest trailing the depth order on the marker path) through
    the graph: the capture call and a replay, at poses of their own,
    equal the eager call bit for bit."""
    n, active = 4_325_376, 665_536
    scene = _scene(cuda, n=n, seed=5)
    scene["scales"] = scene["scales"] * 0.05
    scene["active_mask"] = torch.arange(n, device=cuda) < active
    bg = torch.zeros(3, device=cuda)
    assert not binning.emit_active(n, math.prod(binning.tile_grid_dims(W,
                                                                       H)))

    def render(pose):
        return R.rasterize(camera=_camera(cuda, pose=pose), bg_color=bg,
                           capacity=1 << 22, device="cuda", **scene)

    c0 = dict(R.graph_counts)
    with torch.no_grad():
        got = [render(p) for p in range(3)]    # eager, capture, replay
        with R.eager():
            ref = [render(p) for p in range(3)]
    assert R.graph_counts["captures"] - c0["captures"] == 1
    assert R.graph_counts["replays"] - c0["replays"] == 2
    for g, r in zip(got, ref):
        assert int(r.n_pairs) > 0 and not bool(r.overflow)
        _assert_equal(g, r)
