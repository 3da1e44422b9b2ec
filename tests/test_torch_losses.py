"""The port's losses, k-means and optimizer against the JAX package's, on
the CPU, on the same numpy inputs.

Values and gradients of each loss (f32: rtol 1e-5 / atol 1e-6); k-means
assignment, Lloyd refresh (with an empty cluster and the ema blend) and
bank_write; argmax ties; the fused bf16 projection against JAX's custom
VJP; and the optimizer against optax over 5 updates of the same gradient
sequence, with the clip both active and inactive and lr 0 at the first
update (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu import train as JT
from nafae_tpu.ops import grounding as JG
from nafae_tpu.ops import kmeans as JK
from nafae_tpu.ops import losses as JL
from nafae_torch import train as TT
from nafae_torch.ops import grounding as TG
from nafae_torch.ops import kmeans as TK
from nafae_torch.ops import losses as TL

F32 = dict(rtol=1e-5, atol=1e-6)
B, K, T, R, E, KC = 4, 3, 5, 6, 8, 5


def _data(seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(B, K, E).astype(np.float32)
    v = rng.randn(B, T, R, E).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    fm = (rng.rand(B, T) > 0.25).astype(np.float32)
    fm[:, 0] = 1.0
    wm = (rng.rand(B, K) > 0.3).astype(np.float32)
    wm[:, 0] = 1.0
    rm = (rng.rand(B, T, R) > 0.3).astype(np.float32)
    rm[0, 0] = 0.0                    # a valid frame with no valid region
    nv = (rng.rand(B, T, 4) > 0.3).astype(np.float32)
    centers = rng.randn(KC, E).astype(np.float32)
    return dict(w=w, v=v, fm=fm, wm=wm, rm=rm, nv=nv, centers=centers)


def _both(fn_j, fn_t, args, grad_argnums):
    """Value and gradients of a scalar function in both packages."""
    ja = [jnp.asarray(a) for a in args]
    vj, gj = jax.value_and_grad(fn_j, argnums=grad_argnums)(*ja)
    ta = [torch.from_numpy(a).requires_grad_(i in grad_argnums)
          for i, a in enumerate(args)]
    vt = fn_t(*ta)
    gt = torch.autograd.grad(vt, [ta[i] for i in grad_argnums],
                             allow_unused=True)   # None: stop-gradient
    return (float(vj), [np.asarray(g) for g in gj], vt.item(),
            [np.zeros(args[i].shape, np.float32) if g is None else g.numpy()
             for i, g in zip(grad_argnums, gt)])


def _close(got):
    vj, gj, vt, gt = got
    np.testing.assert_allclose(vt, vj, **F32)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, **F32)


@pytest.mark.parametrize("norm", ["pairs", "hinges", "batch"])
def test_ranking_loss(norm):
    rng = np.random.RandomState(1)
    rows = rng.randn(B, B).astype(np.float32) * 0.2
    _close(_both(lambda x: JL.ranking_loss(x, 0.1, norm),
                 lambda x: TL.ranking_loss(x, 0.1, norm), [rows], (0,)))
    diag = np.diag(rows).copy()
    _close(_both(
        lambda x, d: JL.ranking_hinge_total(x[1:3], d, 1, 0.1),
        lambda x, d: TL.ranking_hinge_total(x[1:3], d, 1, 0.1),
        [rows, diag], (0, 1)))


@pytest.mark.parametrize("target", ["stopgrad", "live", "symmetric"])
@pytest.mark.parametrize("with_rm", [False, True])
def test_context_loss(target, with_rm):
    d = _data(2)
    rng = np.random.RandomState(3)
    s = rng.randn(B, K, T, R).astype(np.float32)
    shat = rng.randn(B, K, T, R).astype(np.float32)
    rm = d["rm"] if with_rm else None

    def lj(s_, sh):
        return JL.context_loss(s_, sh, jnp.asarray(d["wm"]),
                               jnp.asarray(d["fm"]), jnp.asarray(d["nv"]),
                               None if rm is None else jnp.asarray(rm),
                               target)

    def lt(s_, sh):
        return TL.context_loss(s_, sh, torch.from_numpy(d["wm"]),
                               torch.from_numpy(d["fm"]),
                               torch.from_numpy(d["nv"]),
                               None if rm is None else torch.from_numpy(rm),
                               target)

    _close(_both(lj, lt, [s, shat], (0, 1)))


@pytest.mark.parametrize("precomputed", [False, True])
def test_select_top_regions_and_cluster_loss(precomputed):
    d = _data(4)
    rng = np.random.RandomState(5)
    s = rng.randn(B, K, T, R).astype(np.float32)
    s[0, 0, 1, :] = 0.5                       # ties: the first r is taken
    sj = JG.mask_regions(jnp.asarray(s), jnp.asarray(d["rm"]))
    st = TG.mask_regions(torch.from_numpy(s), torch.from_numpy(d["rm"]))
    r_j = JG.argmax_regions_2d(sj)
    r_t = TG.argmax_regions_2d(st)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    assert int(r_t[0, 0, 1]) == int(np.argmax(d["rm"][0, 1] > 0)) or \
        d["rm"][0, 1].sum() == 0

    def lj(v, c):
        f, valid = JL.select_top_regions(
            sj, v, jnp.asarray(d["wm"]), jnp.asarray(d["fm"]),
            jnp.asarray(d["rm"]), r_star=r_j if precomputed else None)
        loss, _ = JL.cluster_loss(f, valid, c)
        return loss + jnp.sum(f * 0.3)

    def lt(v, c):
        f, valid = TL.select_top_regions(
            st, v, torch.from_numpy(d["wm"]), torch.from_numpy(d["fm"]),
            torch.from_numpy(d["rm"]), r_star=r_t if precomputed else None)
        loss, _ = TL.cluster_loss(f, valid, c)
        return loss + torch.sum(f * 0.3)

    got = _both(lj, lt, [d["v"], d["centers"]], (0, 1))
    _close(got)
    assert np.all(got[3][1] == 0.0)           # the target is stop-gradient


def test_kmeans_assign_lloyd_and_bank():
    d = _data(6)
    rng = np.random.RandomState(7)
    f = rng.randn(40, E).astype(np.float32)
    valid = (rng.rand(40) > 0.2).astype(np.float32)
    c = d["centers"].copy()
    c[KC - 1] = -10 * f.mean(0)               # a center nobody picks
    for dt_j, dt_t in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        a_j = JK.kmeans_assign(jnp.asarray(f), jnp.asarray(c), dtype=dt_j) \
            if dt_j is None else None
        a_t = TK.kmeans_assign(torch.from_numpy(f), torch.from_numpy(c),
                               dtype=dt_t)
        if a_j is not None:
            np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        else:   # JAX's CPU backend cannot run the bf16 dot: same argmax as
                # f32 sims of bf16-rounded operands
            fr = torch.from_numpy(f).bfloat16().float()
            cr = TG.l2_normalize(torch.from_numpy(c)).bfloat16().float()
            np.testing.assert_array_equal(a_t.numpy(),
                                          (fr @ cr.T).argmax(-1).numpy())
    for ema in (0.0, 0.3):
        cj = JK.kmeans_lloyd(jnp.asarray(f), jnp.asarray(valid),
                             jnp.asarray(c), 4, ema)
        ct = TK.kmeans_lloyd(torch.from_numpy(f), torch.from_numpy(valid),
                             torch.from_numpy(c), 4, ema)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **F32)
    # bank: a smaller write pads with valid = 0, slot = step % W
    bank = np.zeros((3, 2, 4, K, E), np.float32)
    bv = np.zeros((3, 2, 4, K), np.float32)
    sel = rng.randn(2, 3, K, E).astype(np.float32)
    sv = np.ones((2, 3, K), np.float32)
    bj, vj = JK.bank_write(jnp.asarray(bank), jnp.asarray(bv), 4,
                           jnp.asarray(sel), jnp.asarray(sv))
    bt, vt = TK.bank_write(torch.from_numpy(bank), torch.from_numpy(bv), 4,
                           torch.from_numpy(sel), torch.from_numpy(sv))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(bank, np.asarray(bj))   # in place


def test_project_regions_fused_matches_jax():
    """The bf16-mode projection: the forward equals project_regions cast
    to bf16; the backward (normalize in the compute dtype) matches JAX's
    custom VJP, which runs here only as float32 arithmetic on bf16-rounded
    values, so both sides are fed bf16-exact inputs and held at bf16's
    2e-2."""
    rng = np.random.RandomState(8)
    feats = rng.randn(2, 3, 4, 16).astype(np.float32)
    w = (rng.randn(16, E) / 4).astype(np.float32)
    b = (rng.randn(E) * 0.1).astype(np.float32)
    g = rng.randn(2, 3, 4, E).astype(np.float32)
    ft, wt, bt = (torch.from_numpy(a) for a in (feats, w, b))
    wt.requires_grad_()
    bt.requires_grad_()
    out = TG.project_regions_fused(ft, wt, bt, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out, TG.project_regions(ft, wt.detach(), bt.detach(),
                                dtype=torch.bfloat16).bfloat16(),
        rtol=0, atol=0)
    gw, gb = torch.autograd.grad(out, [wt, bt], torch.from_numpy(g).bfloat16())
    # JAX's rule in f32 (same formula, its residuals rounded to bf16)
    f2 = jnp.asarray(feats.reshape(-1, 16)).astype(jnp.bfloat16).astype(
        jnp.float32)
    v = f2 @ jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32) + b
    inv = jax.lax.rsqrt(jnp.sum(v * v, -1, keepdims=True) + 1e-8)
    vh = (v * inv).astype(jnp.bfloat16).astype(jnp.float32)
    g2 = jnp.asarray(g.reshape(-1, E)).astype(jnp.bfloat16).astype(
        jnp.float32)
    dv32 = (g2 - vh * jnp.sum(g2 * vh, -1, keepdims=True)) * inv
    dw = f2.T @ dv32.astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_allclose(gw.numpy(), np.asarray(dw), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(gb.numpy(), np.asarray(dv32.sum(0)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("clip", [0.5, 100.0, 0.0])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_optimizer_matches_optax(clip, opt):
    over = ["train.lr=0.01", "train.warmup_steps=2", "train.steps=6",
            "train.weight_decay=0.01", f"train.grad_clip={clip}",
            f"train.optimizer={opt}"]
    jc = jcfg.load_config(preset_name="config2", overrides=over)
    tc = tcfg.load_config(preset_name="config2", overrides=over)
    rng = np.random.RandomState(9)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    tx = JT.make_optimizer(jc)
    js = tx.init({k: jnp.asarray(v) for k, v in params.items()})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ttx = TT.make_optimizer(tc)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = ttx.init(tp)
    assert ttx.lr(0) == 0.0
    for i in range(5):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, js = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                            js, jp)
        jp = optax.apply_updates(jp, upd)
        tp_new, ts = ttx.update({k: torch.from_numpy(v)
                                 for k, v in grads.items()}, ts, tp)
        if i == 0:                             # lr 0 at the first update
            for k in tp:
                torch.testing.assert_close(tp_new[k], tp[k], rtol=0, atol=0)
        tp = tp_new
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
