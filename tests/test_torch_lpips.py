"""The port's LPIPS (`gaussianrpg_tpu_torch/utils/lpips.py`) against the
JAX package's (`gaussianrpg_tpu/utils/lpips.py`) on the same weights:
`init_params` draws the same numbers in both, `params_from_jax` carries a
JAX tree across, `load_torch_lpips` reads torchvision / richzhang state
dicts; and the metrics app's LPIPS wiring (`apps/metrics.evaluate_dir`)
against the JAX app's."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.utils import lpips as jl  # noqa: E402

from gaussianrpg_tpu_torch.data.image_io import write_png  # noqa: E402
from gaussianrpg_tpu_torch.utils import lpips as tl  # noqa: E402

from .torch_parity import one_cpu_thread  # noqa: E402,F401

RTOL = 1e-5   # LPIPS distance, port vs JAX on the same weights and inputs

SPECS = [("alex", tl.ALEX_SPEC, jl.ALEX_SPEC, (67, 83)),
         ("vgg", tl.VGG16_SPEC, jl.VGG16_SPEC, (40, 56))]


def _pair(rng, hw, lo=-1.0):
    x = rng.uniform(lo, 1, (3,) + hw).astype(np.float32)
    y = np.clip(x + 0.15 * rng.standard_normal(x.shape), lo,
                1).astype(np.float32)
    return x, y


def test_specs_are_the_jax_specs():
    assert tl.ALEX_SPEC == jl.ALEX_SPEC and tl.VGG16_SPEC == jl.VGG16_SPEC


@pytest.mark.parametrize("name,tspec,jspec,hw", SPECS,
                         ids=[s[0] for s in SPECS])
def test_lpips_matches_jax_on_random_weights(name, tspec, jspec, hw):
    """`init_params(spec, seed)` draws the JAX package's weights (OIHW of
    its HWIO); the distance of a perturbed pair within RTOL, batched as
    [N, 3, H, W] too; identity gives 0."""
    jparams = jl.init_params(jspec, seed=1)
    tparams = tl.init_params(tspec, seed=1)
    for (tw, tb), (jw, jb) in zip(tparams["convs"], jparams["convs"]):
        np.testing.assert_array_equal(
            tw.numpy(), np.asarray(jw).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for a, b in zip(tparams["lins"], jparams["lins"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    net = tl.LPIPS(tspec, tparams)
    rng = np.random.default_rng(0)
    x, y = _pair(rng, hw)
    want = float(jl.lpips(jspec, jparams, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = float(net(torch.from_numpy(x), torch.from_numpy(y)))
        batch = net(torch.from_numpy(np.stack([x, y])),
                    torch.from_numpy(np.stack([y, y])))
        same = float(net(torch.from_numpy(x), torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=RTOL) and got > 1e-6
    assert batch.shape == (2,)
    assert float(batch[0]) == pytest.approx(want, rel=RTOL)
    assert float(batch[1]) == 0.0 and same == 0.0


@pytest.mark.parametrize("name,tspec,jspec,hw", SPECS,
                         ids=[s[0] for s in SPECS])
def test_features_match_jax(name, tspec, jspec, hw):
    """Every tap (shape and values, NCHW against NHWC) within 1e-5 of the
    largest activation."""
    jparams = jl.init_params(jspec, seed=4)
    net = tl.LPIPS(tspec, tl.params_from_jax(jparams))
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (1, 3) + hw).astype(np.float32)
    want = jl.features(jspec, jparams, jnp.asarray(x))
    with torch.no_grad():
        got = net.features(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-5 * np.abs(w).max())


def test_params_from_jax():
    """A JAX tree (HWIO) carried across: conv weights transposed to OIHW,
    biases and lins as they are; the distances agree within RTOL."""
    jparams = jl.init_params(jl.ALEX_SPEC, seed=2)
    rng = np.random.default_rng(2)
    jparams["convs"] = [(w, jnp.asarray(rng.standard_normal(b.shape)
                                        .astype(np.float32) * 0.1))
                        for w, b in jparams["convs"]]
    tparams = tl.params_from_jax(jparams)
    for (tw, tb), (jw, jb) in zip(tparams["convs"], jparams["convs"]):
        assert tw.shape == tuple(np.asarray(jw).shape[i] for i in
                                 (3, 2, 0, 1))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    x, y = _pair(rng, (35, 35))
    want = float(jl.lpips(jl.ALEX_SPEC, jparams, jnp.asarray(x),
                          jnp.asarray(y)))
    with torch.no_grad():
        got = float(tl.LPIPS(tl.ALEX_SPEC, tparams)(torch.from_numpy(x),
                                                    torch.from_numpy(y)))
    assert got == pytest.approx(want, rel=RTOL)


def _params(spec, rng, scale=1.0):
    """Random conv weights (times `scale`), biases and lin weights in
    `spec`'s layout (`init_params` layout, non-zero biases)."""
    convs, cin = [], 3
    for e in spec["convs"]:
        if e in ("M", "P"):
            continue
        cout, k = e[0], e[1]
        convs.append((
            torch.from_numpy((rng.standard_normal((cout, cin, k, k)) * scale
                              / np.sqrt(k * k * cin)).astype(np.float32)),
            torch.from_numpy((0.01 * rng.standard_normal(cout))
                             .astype(np.float32))))
        cin = cout
    lins = [torch.from_numpy(np.abs(rng.standard_normal(c))
                             .astype(np.float32)) for c in spec["channels"]]
    return {"convs": convs, "lins": lins}


@pytest.mark.parametrize("net_type", ["alex", "vgg"])
def test_load_torch_lpips_matches_jax(net_type, tmp_path):
    """State dicts written to `tmp_path` by `save_torch_lpips` carry
    torchvision's `features.{i}` indices (alexnet 0, 3, 6, 8, 10; vgg16 0,
    2, 5, ... 28) and richzhang's `lin{k}.model.1.weight` [1, C, 1, 1];
    the port's module holds them as written, and its distance equals the
    JAX conversion's within RTOL."""
    spec = tl.ALEX_SPEC if net_type == "alex" else tl.VGG16_SPEC
    rng = np.random.default_rng(3)
    params = _params(spec, rng)
    bp, lp = str(tmp_path / "net.pth"), str(tmp_path / "lin.pth")
    tl.save_torch_lpips(spec, params, bp, lp)
    sd, ld = torch.load(bp), torch.load(lp)
    keys = sorted({int(k.split(".")[1]) for k in sd})
    assert keys == ([0, 3, 6, 8, 10] if net_type == "alex" else
                    [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28])
    assert sorted(ld) == [f"lin{k}.model.1.weight"
                          for k in range(len(spec["channels"]))]
    assert ld["lin0.model.1.weight"].shape == (1, spec["channels"][0], 1, 1)
    net = tl.load_torch_lpips(bp, lp, net_type, device="cpu")
    np.testing.assert_array_equal(net.convs[0].weight.numpy(),
                                  params["convs"][0][0].numpy())
    np.testing.assert_array_equal(net.convs[-1].bias.numpy(),
                                  params["convs"][-1][1].numpy())
    np.testing.assert_array_equal(net.lin4.numpy(),
                                  params["lins"][4].numpy())
    jspec, jparams = jl.load_torch_lpips(bp, lp, net_type)
    x, y = _pair(rng, (35, 35) if net_type == "alex" else (40, 56))
    want = float(jl.lpips(jspec, jparams, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = float(net(torch.from_numpy(x), torch.from_numpy(y)))
    assert np.isfinite(got) and got == pytest.approx(want, rel=RTOL)


def test_lpips_fn_zero_one_convention():
    """`lpips_fn` maps [0, 1] inputs to [-1, 1]: it equals the module on
    2x - 1 and the JAX `lpips_fn` on the same images."""
    fn = tl.lpips_fn("alex", device="cpu")
    jfn = jl.lpips_fn("alex")
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (3, 35, 35)).astype(np.float32)
    b = rng.uniform(0, 1, (3, 35, 35)).astype(np.float32)
    d = float(fn(torch.from_numpy(a), torch.from_numpy(b)))
    with torch.no_grad():
        direct = float(tl.LPIPS(tl.ALEX_SPEC)(torch.from_numpy(a * 2 - 1),
                                              torch.from_numpy(b * 2 - 1)))
    assert np.isfinite(d) and d > 0 and d == direct
    assert d == pytest.approx(float(jfn(jnp.asarray(a), jnp.asarray(b))),
                              rel=RTOL)
    assert float(fn(torch.from_numpy(a), torch.from_numpy(a))) == 0.0


def test_metrics_app_lpips_wiring(tmp_path):
    """`apps.metrics.evaluate_dir` computes LPIPS through the port's
    module when `eval.lpips` names weight files, equal within RTOL to the
    JAX app's `evaluate_dir` on the same PNGs; no LPIPS when the files are
    absent (and no `lpips` package is installed)."""
    from gaussianrpg_tpu.apps.metrics import evaluate_dir as jeval

    from gaussianrpg_tpu_torch.apps.metrics import evaluate_dir as teval

    rng = np.random.default_rng(5)
    d = tmp_path / "evaluate_test"
    d.mkdir()
    for n in ("000", "001"):
        a = rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
        b = np.clip(a + rng.integers(-20, 20, a.shape), 0,
                    255).astype(np.uint8)
        write_png(str(d / f"{n}_rgb.png"), a)
        write_png(str(d / f"{n}_gt.png"), b)
    bp, lp = str(tmp_path / "alex.pth"), str(tmp_path / "lin.pth")
    tl.save_torch_lpips(tl.ALEX_SPEC, _params(tl.ALEX_SPEC, rng, scale=0.5),
                        bp, lp)
    cfg = {"backbone_path": bp, "lin_path": lp, "net_type": "alex"}
    got, per_view = teval(str(d), cfg, device="cpu")
    want, _ = jeval(str(d), cfg)
    assert got["n_views"] == 2 and sorted(per_view) == ["000", "001"]
    assert np.isfinite(got["lpips"]) and got["lpips"] > 0
    assert got["lpips"] == pytest.approx(want["lpips"], rel=RTOL)
    missing = dict(cfg, lin_path=str(tmp_path / "absent.pth"))
    got2, _ = teval(str(d), missing, device="cpu")
    assert "lpips" not in got2
