"""The port's Ghost Batch Norm (plain versions, autograd wiring, gbn_apply)
held to the JAX package: ``repro.kernels.ref`` and the Pallas kernels in
interpret mode, f32, at the reference tests' tolerance (1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.core import gbn as JG
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import gbn as TG
from repro_torch.kernels import gbn as K
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 1e-4
GBN_SHAPES = [(1, 16, 8), (4, 300, 96), (2, 1024, 128), (3, 77, 200)]


def _close(a, b, tol=TOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    G, R, C = shape
    x = (2.0 * rng.randn(G, R, C) + 0.5).astype(np.float32)
    gamma = np.linspace(0.5, 1.5, C, dtype=np.float32)
    beta = np.linspace(-1.0, 1.0, C, dtype=np.float32)
    cts = (rng.randn(G, R, C).astype(np.float32),
           rng.randn(G, C).astype(np.float32),
           rng.randn(G, C).astype(np.float32))
    return x, gamma, beta, cts


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("shape", GBN_SHAPES)
def test_gbn_forward_matches_reference(shape):
    x, gamma, beta, _ = _inputs(shape, sum(shape))
    y, mu, var = tref.gbn_ref(*_t(x, gamma, beta))
    for jout in (jref.gbn_ref(x, gamma, beta),
                 jops.gbn_forward(jnp.asarray(x), gamma, beta)):
        for a, b in zip((y, mu, var), jout):
            _close(a, b)


@pytest.mark.parametrize("shape", GBN_SHAPES)
def test_gbn_vjp_matches_reference(shape):
    """Gradients through the port's autograd Function (its CPU path) equal
    the JAX custom_vjp (Pallas backward, interpret) and the hand VJP, with
    live cotangents on all three outputs."""
    x, gamma, beta, cts = _inputs(shape, 7 * sum(shape))
    xt, gt, bt = _t(x, gamma, beta, grad=True)
    outs = tops.gbn_forward(xt, gt, bt)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cts))
    got = torch.autograd.grad(loss, (xt, gt, bt))

    _, vjp = jax.vjp(lambda a, g, b: jops.gbn_forward(a, g, b),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    for want in (vjp(tuple(jnp.asarray(c) for c in cts)),
                 jref.gbn_vjp_ref(x, gamma, beta, cts)):
        for a, b in zip(got, want):
            _close(a, b)
    for a, b in zip(tref.gbn_vjp_ref(*_t(x, gamma, beta),
                                     tuple(_t(*cts))), got):
        _close(a, b)


GBN_APPLY_CASES = [
    # (x shape, ghost, use_kernels): leftover rows, plain BN limit, conv
    ((70, 24), 16, True),
    ((70, 24), 16, False),
    ((64, 24), 16, True),
    ((12, 6), 32, True),
    ((40, 4, 4, 8), 16, True),
    ((40, 4, 4, 8), 16, False),
]


@pytest.mark.parametrize("shape,ghost,use_kernels", GBN_APPLY_CASES)
def test_gbn_apply_matches_reference(shape, ghost, use_kernels):
    rng = np.random.RandomState(len(shape) * 100 + shape[0])
    C = shape[-1]
    x = (2.0 * rng.randn(*shape) + 1.0).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    jp, js = JG.gbn_init(C)
    jp = {"gamma": jnp.asarray(rng.rand(C) + 0.5, jnp.float32),
          "beta": jnp.asarray(rng.randn(C), jnp.float32)}

    def jloss(p, state):
        y, ns = JG.gbn_apply(p, state, jnp.asarray(x), ghost_batch_size=ghost,
                             use_kernels=use_kernels)
        return (y * w).sum(), (y, ns)

    (_, (jy, jns)), jgrad = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jp, js)

    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    _, ts = TG.gbn_init(C)
    ty, tns = TG.gbn_apply(tp, ts, torch.tensor(x), ghost_batch_size=ghost,
                           use_kernels=use_kernels)
    tgrad = torch.autograd.grad((ty * torch.tensor(w)).sum(),
                                (tp["gamma"], tp["beta"]))
    _close(ty, jy)
    for k in ("mu_run", "var_run"):
        _close(tns[k], jns[k])
    assert bool(tns["initialized"])
    _close(tgrad[0], jgrad["gamma"])
    _close(tgrad[1], jgrad["beta"])

    # second call: the cascaded EMA from the initialized state, then eval
    jy2, jns2 = JG.gbn_apply(jp, jns, jnp.asarray(x * 0.5 + 2.0),
                             ghost_batch_size=ghost, momentum=0.3,
                             use_kernels=use_kernels)
    ty2, tns2 = TG.gbn_apply(tp, tns, torch.tensor(x * 0.5 + 2.0),
                             ghost_batch_size=ghost, momentum=0.3,
                             use_kernels=use_kernels)
    for k in ("mu_run", "var_run"):
        _close(tns2[k], jns2[k])
    jye, _ = JG.gbn_apply(jp, jns2, jnp.asarray(x), ghost_batch_size=ghost,
                          training=False)
    tye, _ = TG.gbn_apply(tp, tns2, torch.tensor(x), ghost_batch_size=ghost,
                          training=False)
    _close(tye, jye)


@pytest.mark.parametrize("G,eta", [(1, 0.1), (5, 0.1), (32, 0.25)])
def test_cascaded_ema_matches_reference(G, eta):
    rng = np.random.RandomState(G)
    run = rng.randn(6).astype(np.float32)
    per = rng.randn(G, 6).astype(np.float32)
    _close(TG._cascaded_ema(torch.tensor(run), torch.tensor(per), eta),
           JG._cascaded_ema(jnp.asarray(run), jnp.asarray(per), eta))


def test_equal_weight_bn_matches_reference():
    rng = np.random.RandomState(5)
    x = (3.0 * rng.randn(48, 3, 3, 10) - 1.0).astype(np.float32)
    jp, js = JG.gbn_init(10)
    tp, ts = TG.gbn_init(10)
    for _ in range(2):
        jy, js = JG.equal_weight_bn_apply(jp, js, jnp.asarray(x))
        ty, ts = TG.equal_weight_bn_apply(tp, ts, torch.tensor(x))
        _close(ty, jy)
        for k in ("mu_run", "var_run"):
            _close(ts[k], js[k])
        x = x * 0.5 + 1.0


def test_wrappers_take_plain_path_on_cpu_without_counting():
    x, gamma, beta, cts = _inputs((2, 33, 10), 3)
    K.reset_launches()
    y, mu, var = K.gbn_forward(*_t(x, gamma, beta))
    dx, dg, db = K.gbn_backward(*_t(x, gamma), mu, var, *_t(*cts))
    assert K.launches == {"gbn_forward": 0, "gbn_backward": 0}
    for a, b in zip((y, mu, var), jref.gbn_ref(x, gamma, beta)):
        _close(a, b)
    for a, b in zip((dx, dg, db), jref.gbn_vjp_ref(x, gamma, beta, cts)):
        _close(a, b)


PATH_SHAPES = [(32, 131072, 16), (32, 32768, 32), (32, 8192, 64),
               (32, 128, 512), (3, 77, 200), (1, 16, 8), (2, 33, 10),
               (1, 5, 4096)]


@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_geometry_covers_every_row_once(shape):
    G, R, C = shape
    g = K.geometry(G, R, C)
    assert g.vec == (4 if C % 4 == 0 else 1)
    cv = C // g.vec
    lanes = g.threads // cv
    assert lanes >= 1 and g.chunk_rows % lanes == 0
    assert (g.nchunks - 1) * g.chunk_rows < R <= g.nchunks * g.chunk_rows
    assert g.threads in (256, 512, 1024)
    if C <= 1024:
        assert K.geometry(G, R, C, aligned=False).vec == 1


@pytest.mark.parametrize("shape", [(1, 8, 4100), (65536, 4, 8), (0, 4, 8),
                                   (1, 8, 1025)])
def test_geometry_rejects_shapes_past_the_kernel_limits(shape):
    with pytest.raises(ValueError):
        K.geometry(*shape)
