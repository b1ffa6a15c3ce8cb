"""The row gather of `ops/gather.py` (kernel `csrc/gather_rows.cu`) on the
rasterizer's eval path: `pair_rows`' depth-order take and pair gather.

Before the kernel, the eval pair gather was `index_select` of the clamped
row ids times the float valid mask, and the marker path's depth take
`index_select` by the order. The tests hold `pair_rows` to that formula
(`_old_take`, patched in for `gather.gather_rows`) on both binning paths,
with padding slots and at widths 16, 24 and 96 (the last above the 48 KB
of shared memory a block gets by default). Values compare with -0.0
mapped to +0.0 (the old product gave -0.0 in padding rows for negative
fields).
The card tests run the kernel; they skip without a card. This file
imports neither JAX nor the JAX package.
"""
import math

import numpy as np
import pytest
import torch

from gaussianrpg_tpu_torch.ops import binning, gather, raster_graph
from gaussianrpg_tpu_torch.ops import rasterize as R
from gaussianrpg_tpu_torch.render.camera import make_camera
from gaussianrpg_tpu_torch.tools import gather_fold

from .torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)

W, H = 128, 96


def _camera(device, width=W, height=H):
    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    return make_camera(R=np.eye(3), T=np.zeros(3), K=None, width=width,
                       height=height, fovx=fovx, fovy=fovy, device=device)


def _scene(device, n, s_ch=0, seed=3, active=None):
    """n Gaussians in front of the camera, s_ch semantic channels, and
    with `active` only the first `active` of them shown (the street
    builder's trailing inactive slots)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(1, 8, n)], -1)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    host = dict(means3d=means, opacities=rng.uniform(0.05, 0.95, n),
                colors=rng.uniform(0, 1, (n, 3)),
                scales=np.exp(rng.uniform(-3.5, -1.0, (n, 3))), rotations=q)
    if s_ch:
        host["semantics"] = rng.normal(0, 1, (n, s_ch))
    out = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
           for k, v in host.items()}
    if active is not None:
        out["active_mask"] = torch.arange(n, device=device) < active
    return out


def _fields(scene, tile):
    s = dict(scene)
    return R.primitive_fields(s.pop("means3d"), s.pop("opacities"),
                              camera=_camera(scene["means3d"].device),
                              tile_x=tile[0], tile_y=tile[1], **s)


def _old_take(table, idx):
    """The eval row take before the kernel: `index_select` of the clamped
    ids times the float valid mask (for the depth take, a permutation, the
    mask is all ones and the product the `index_select` itself)."""
    valid = (idx >= 0).to(table.dtype)
    return table.index_select(0, torch.clamp(idx, min=0).long()) \
        * valid[:, None]


def _pair_rows(fs, capacity, old, monkeypatch):
    with monkeypatch.context() as m:
        if old:
            m.setattr(gather, "gather_rows", _old_take)
        return R.pair_rows(fs, width=W, height=H, capacity=capacity)


def _assert_same(got, ref):
    gdata, lists = got
    ref_gdata, ref_lists = ref
    assert gdata.shape == ref_gdata.shape and gdata.is_contiguous()
    assert torch.equal(gdata + 0.0, ref_gdata + 0.0)
    for name in ("pair_src", "pair_valid", "tile_nonempty"):
        assert torch.equal(getattr(lists, name), getattr(ref_lists, name))
    assert bool((lists.pair_src < 0).any()), "no padding slot in the list"


# -- on the CPU: the plain version ------------------------------------------

@pytest.mark.parametrize("emit", [True, False], ids=["emission", "marker"])
@pytest.mark.parametrize("s_ch,nf", [(0, 16), (3, 16), (13, 24), (82, 96)])
def test_eval_pair_rows_equals_the_old_formula(emit, s_ch, nf, monkeypatch):
    """Both binning paths, widths 16 (with spare columns for the marker
    path's rect, and without), 24 and 96."""
    monkeypatch.setattr(binning, "EMIT_PAIRS", emit)
    fs = _fields(_scene("cpu", 2000, s_ch), (16, 16))
    assert fs.fields.shape[1] == nf
    assert binning.emit_active(2000, math.prod(
        binning.tile_grid_dims(W, H, 16, 16))) == emit
    got = _pair_rows(fs, 1 << 16, False, monkeypatch)
    _assert_same(got, _pair_rows(fs, 1 << 16, True, monkeypatch))


def test_gather_rows_checks_its_inputs():
    """Any width that is a positive multiple of 4 (no cap: wide tables
    opt in to more shared memory on the card); a width that is not, a
    float64 table or int64 ids are refused."""
    idx = torch.tensor([2, -1, 0, 1], dtype=torch.int32)
    for nf in (4, 16, 92, 96, 452):
        table = torch.randn(3, nf)
        got = gather.gather_rows(table, idx)
        assert torch.equal(got + 0.0, _old_take(table, idx) + 0.0)
    with pytest.raises(ValueError, match="multiple of 4"):
        gather.gather_rows(torch.randn(3, 18), idx)
    with pytest.raises(TypeError, match="float32"):
        gather.gather_rows(torch.randn(3, 16, dtype=torch.float64), idx)
    with pytest.raises(TypeError, match="int32"):
        gather.gather_rows(torch.randn(3, 16), idx.long())


def test_the_kernel_path_gradient_adds_rows_back(monkeypatch):
    """Where autograd records the table, the kernel's gather goes through
    `_GatherRows`: its backward adds each output row's gradient into the
    table row it came from, and nothing for ids outside the table. Here
    the plain version stands in for the launch; the gradient equals
    autograd's of the plain version."""
    monkeypatch.setattr(gather, "_launch", gather.gather_rows_plain)
    table = torch.randn(5, 8, requires_grad=True)
    idx = torch.tensor([4, -1, 0, 4, 7, 2, 0], dtype=torch.int32)
    weight = torch.randn(7, 8)
    got = gather._GatherRows.apply(table, idx)
    assert torch.equal(got, gather.gather_rows_plain(table, idx))
    (g,) = torch.autograd.grad((got * weight).sum(), table)
    (ref,) = torch.autograd.grad(
        (gather.gather_rows_plain(table, idx) * weight).sum(), table)
    torch.testing.assert_close(g, ref, rtol=0, atol=1e-6)
    assert not g[[1, 3]].any()


def test_gather_rows_plain_zero_fills_out_of_range_rows():
    """Row ids below 0 and at or above N give zero rows (+0.0); the rest
    are the table's rows."""
    table = -torch.arange(1.0, 25.0).reshape(6, 4)
    src = torch.tensor([-7, 5, -1, 6, 0, 99, 3], dtype=torch.int32)
    got = gather.gather_rows_plain(table, src)
    assert torch.equal(got[[1, 4, 6]], table[[5, 0, 3]])
    zero = got[[0, 2, 3, 5]]
    assert torch.equal(zero, torch.zeros_like(zero))
    assert not torch.signbit(zero).any()
    assert torch.equal(gather.gather_rows(table, src), got)


def test_the_tool_re_exports_the_ops_gather():
    """`tools.gather_fold` times the rasterizer's own gather."""
    assert gather_fold.gather_rows is gather.gather_rows
    assert gather_fold.gather_rows_plain is gather.gather_rows_plain


def test_replays_advance_the_gather_counter():
    """The row gather's launch counter is among those a replay
    advances."""
    assert (gather, "launches") in raster_graph.COUNTERS


# -- on the card: the kernel -------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    raster_graph.release()
    yield torch.device("cuda")
    raster_graph.release()


# (scene, Gaussians, shown, capacity): the street builder's slot layout
# (4,325,376 slots, 665,536 shown, marker path since N > 2^20) and a
# frozen-style scene, every Gaussian shown (emission path)
LAYOUTS = {"street": (4_325_376, 665_536, 1 << 22),
           "frozen": (60_000, None, 1 << 20)}


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 16), (64, 32)], ids=str)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_eval_pair_rows_kernel_equals_the_old_formula(cuda, layout, tile,
                                                      monkeypatch):
    """The kernel's gdata and pair lists equal the old formula's on the
    card, bit for bit but for the padding rows' sign of zero; two gather
    launches a marker-path frame, one an emission-path frame."""
    n, active, cap = LAYOUTS[layout]
    scene = _scene(cuda, n, seed=5, active=active)
    scene["scales"] = scene["scales"] * (0.05 if active else 0.3)
    fs = _fields(scene, tile)
    emit = binning.emit_active(n, math.prod(
        binning.tile_grid_dims(W, H, *tile)))
    assert emit == (layout == "frozen")
    with torch.no_grad():
        n0 = gather.launches
        got = _pair_rows(fs, cap, False, monkeypatch)
        torch.cuda.synchronize()
        launched = gather.launches - n0
        ref = _pair_rows(fs, cap, True, monkeypatch)
    assert launched == (1 if emit else 2)
    _assert_same(got, ref)
    assert int(got[1].padded_total) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_replay_advances_the_gather_counters_by_the_capture(cuda, layout):
    """A replay of the render's CUDA graph advances `gather.launches` by
    what the eager call ran: 2 launches (depth take, pair gather) on the
    street layout, 1 on the emission path; the trace's `gather_rows`
    records agree."""
    from gaussianrpg_tpu_torch.tools._timing import kernel_trace

    n, active, cap = LAYOUTS[layout]
    scene = _scene(cuda, n, seed=5, active=active)
    scene["scales"] = scene["scales"] * (0.05 if active else 0.3)
    bg = torch.zeros(3, device=cuda)

    def render():
        return R.rasterize(camera=_camera(cuda), bg_color=bg, capacity=cap,
                           device="cuda", **scene)

    def deltas(fn):
        b = gather.launches
        fn()
        torch.cuda.synchronize()
        return gather.launches - b

    trace = []
    with torch.no_grad():
        eager = deltas(render)
        capture = deltas(render)
        r0 = R.graph_counts["replays"]
        replay = deltas(render)
        traced = deltas(lambda: trace.extend(kernel_trace(render, reps=3)))
    assert R.graph_counts["replays"] == r0 + 1 + 7
    assert eager == (2 if layout == "street" else 1)
    assert replay == eager and capture == 2 * eager
    assert traced == 7 * eager
    records = sum(k["launches_per_call"] for k in trace
                  if "gather_rows" in k["name"])
    assert records == eager


@pytest.mark.cuda
def test_grad_recording_eval_call_runs_the_kernel_and_its_backward(cuda):
    """An eval call whose table autograd records runs the kernel (one
    launch) and gives the gradient autograd gives the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    table = torch.randn((500, 16), generator=gen, device=cuda,
                        requires_grad=True)
    idx = torch.randint(0, 500, (2000,), dtype=torch.int32, generator=gen,
                        device=cuda)
    idx[::9] = -1
    weight = torch.randn((2000, 16), generator=gen, device=cuda)
    n0 = gather.launches
    got = gather.gather_rows(table, idx)
    assert gather.launches == n0 + 1 and got.requires_grad
    ref = gather.gather_rows_plain(table, idx)
    assert torch.equal(got, ref)
    (g,) = torch.autograd.grad((got * weight).sum(), table)
    (g_ref,) = torch.autograd.grad((ref * weight).sum(), table)
    torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-5)
