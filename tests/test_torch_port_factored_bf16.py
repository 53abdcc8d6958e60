"""The bf16 contract of the three factored kernels (K2 factored_ln_stats, K3
factored_t2i_attention, K4 factored_i2t_scores) on the CPU: the port's
plain bf16 versions, which its dispatches take for bfloat16 CPU tensors,
against the JAX package's Pallas kernels in interpret mode on the same bf16
inputs (the form the JAX package runs them in: only in bf16), at tiny
widths, with the scaled-block cases of `test_torch_port_sam_modules.py`.

- K3, K4 within atol 8e-3, the JAX package's own bf16 kernel tolerance
  (the bf16 output's rounding: one ulp in [1, 2));
- K2's fp32 (mu, 1/sigma) within atol = rtol = 1e-4 (fp32 arithmetic on
  bf16 values, summed in another order), on the moments mS, qS rounded to
  bf16 as the JAX package forms them;
- K2 summed in its bf16 entry's order (each block's product scaled after
  it) against the same Pallas kernel, within the same tolerance;
- the exact split of K2's scaled rows into two bf16 (the bf16 entry's
  products of a scaled block past the first rest on it);
- the dispatches refuse float16 and mixed dtypes."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sam6d_tpu.kernels import factored_t2i as jfac
from sam6d_tpu.models import sam as jsam
from sam6d_torch.kernels import factored
from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)

BF = torch.bfloat16
JBF = ml_dtypes.bfloat16
KERNEL_ATOL = 8e-3
LN_TOL = 1e-4


def _state(rng, ranks, scaled, B=3, N=40, C=32, d=16, T=7):
    """The factor state of `test_torch_port_sam_modules._state`, rounded to
    bf16 (numpy arrays of dtype bfloat16)."""
    def bf(x):
        return np.asarray(x, np.float32).astype(JBF)
    blocks = tuple((bf(rng.rand(B, r, N)), bf(rng.rand(B, N) + 0.5) if s else None)
                   for r, s in zip(ranks, scaled))
    R = sum(ranks)
    arr = {k: bf(rng.randn(*s) * sc) for k, s, sc in (
        ("S", (N, C), 1.0), ("U", (B, R, C), 0.3), ("UK", (B, R, d), 0.3),
        ("UV", (B, R, d), 0.3), ("q", (B, T, d), 0.3), ("KS", (N, d), 0.3),
        ("KC", (N, d), 0.3), ("VS", (N, d), 1.0))}
    arr["a"] = bf(rng.rand(B, N) + 0.5)
    return blocks, arr


def t16(x):
    return None if x is None else torch.from_numpy(np.asarray(x).astype(np.float32)).to(BF)


def j16(x):
    return None if x is None else jnp.asarray(x)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def _blocks(blocks, conv):
    return tuple((conv(p), conv(s)) for p, s in blocks)


@pytest.mark.parametrize("ranks,scaled,with_a", [((9,), (False,), False),
                                                 ((9, 2, 9), (True, True, False), True)])
def test_ln_stats_bf16_plain_matches_pallas(ranks, scaled, with_a):
    """The JAX kernel takes the port's bf16 moments (`ln_moments`, within a
    bf16 ulp of `jnp.mean`'s), so both sides see the same mS, qS."""
    blocks, x = _state(np.random.RandomState(6), ranks, scaled)
    a = x["a"] if with_a else None
    mS, qS = factored.ln_moments(t16(x["S"]))
    assert mS.dtype == qS.dtype == BF
    S = jnp.asarray(x["S"])
    np.testing.assert_allclose(f32(mS), f32(jnp.mean(S, -1)), rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(f32(qS), f32(jnp.mean(S * S, -1)), rtol=2 ** -8, atol=0)
    with pltpu.force_tpu_interpret_mode():
        mu_w, inv_w = jfac.factored_ln_stats(
            _blocks(blocks, j16), jnp.asarray(x["U"]), S,
            jnp.asarray(f32(mS).astype(JBF)), jnp.asarray(f32(qS).astype(JBF)), j16(a))
    mu, inv = factored.factored_ln_stats(_blocks(blocks, t16), t16(x["U"]), t16(x["S"]),
                                         t16(a))
    assert mu.dtype == inv.dtype == torch.float32
    np.testing.assert_allclose(f32(mu), f32(mu_w), atol=LN_TOL, rtol=LN_TOL)
    np.testing.assert_allclose(f32(inv), f32(inv_w), atol=LN_TOL, rtol=LN_TOL)


def _ln_stats_kernel_order(blocks, U, S, a, eps=1e-6):
    """K2's bf16 entry in its own order, in fp32 on the bf16 values: the
    blocks with rows, a scaled one first, x_l = s_0 (Pd_0^T U_0) (that
    block's fp32 product scaled per position), then each other block's
    product added, a scaled one as (Pd s)^T U (its exact hi + lo split);
    the channel sums of x_l, S x_l and x_l^2 with the bf16 mS, qS."""
    mS, qS = (m.float() for m in factored.ln_moments(S))
    offs = np.cumsum([0] + [pd.shape[1] for pd, _ in blocks])
    live = [i for i, (pd, _) in enumerate(blocks) if pd.shape[1] > 0]
    first = next((i for i in live if blocks[i][1] is not None), None)
    order = ([first] if first is not None else []) + [i for i in live if i != first]
    x = None
    for k, i in enumerate(order):
        pd, sc = (None if v is None else v.float() for v in blocks[i])
        u = U[:, offs[i]:offs[i + 1]].float()
        if k == 0:
            x = torch.einsum("brn,brc->bnc", pd, u)
            if sc is not None:
                x = x * sc[:, :, None]
        else:
            x = x + torch.einsum("brn,brc->bnc", pd if sc is None else pd * sc[:, None, :], u)
    C = S.shape[-1]
    mu_d, cr = x.sum(-1) / C, (S.float()[None] * x).sum(-1) / C
    d2 = (x * x).sum(-1) / C
    av = 1.0 if a is None else a.float()
    mu = av * mS + mu_d
    return mu, torch.rsqrt(av * av * qS + 2.0 * av * cr + d2 - mu * mu + eps)


@pytest.mark.parametrize("ranks,scaled,with_a", [
    ((9,), (False,), False),
    ((9, 2, 9), (True, False, False), True),    # the iou pass's layer-2 blocks
    ((9, 2, 9), (True, True, False), True),     # a second scaled block: its split
    ((2, 9, 5), (False, True, True), True),     # the first scaled block taken first
])
def test_ln_stats_bf16_kernel_order_matches_pallas(ranks, scaled, with_a):
    """The bf16 entry scales each block's fp32 product after the product
    (the Pallas kernel forms tilde = Pd s first and the statistics from U's
    gram matrix): the same sums in another fp32 order, within the plain
    version's tolerance of the Pallas kernel."""
    blocks, x = _state(np.random.RandomState(10), ranks, scaled)
    a = x["a"] if with_a else None
    mS, qS = factored.ln_moments(t16(x["S"]))
    with pltpu.force_tpu_interpret_mode():
        mu_w, inv_w = jfac.factored_ln_stats(
            _blocks(blocks, j16), jnp.asarray(x["U"]), jnp.asarray(x["S"]),
            jnp.asarray(f32(mS).astype(JBF)), jnp.asarray(f32(qS).astype(JBF)), j16(a))
    mu, inv = _ln_stats_kernel_order(_blocks(blocks, t16), t16(x["U"]), t16(x["S"]), t16(a))
    np.testing.assert_allclose(f32(mu), f32(mu_w), atol=LN_TOL, rtol=LN_TOL)
    np.testing.assert_allclose(f32(inv), f32(inv_w), atol=LN_TOL, rtol=LN_TOL)


@pytest.mark.parametrize("ranks,scaled,q_mag", [((9, 2), (True, False), 1.0),
                                                ((9, 2, 9, 2), (True, True, True, False), 1.0),
                                                ((9, 2, 9, 2), (True, True, True, False), 4.0)])
def test_t2i_attention_bf16_plain_matches_pallas(ranks, scaled, q_mag):
    """The port returns the head-diagonal blocks: held to the Pallas kernel
    composed with _heads_diag_out; the last case has four times the
    scores (a sharp softmax over the N positions)."""
    heads = 4
    blocks, x = _state(np.random.RandomState(7), ranks, scaled)
    q = (f32(x["q"]) * q_mag).astype(JBF)
    qb = jsam._heads_block_q(jnp.asarray(q), heads, 4)
    with pltpu.force_tpu_interpret_mode():
        want = jfac.factored_t2i_attention(
            qb, jnp.asarray(x["UK"]), jnp.asarray(x["UV"]), _blocks(blocks, j16),
            jnp.asarray(x["a"]), *(jnp.asarray(x[k]) for k in ("KS", "KC", "VS")))
    got = factored.factored_t2i_attention(
        t16(q), t16(x["UK"]), t16(x["UV"]), _blocks(blocks, t16), t16(x["a"]),
        t16(x["KS"]), t16(x["KC"]), t16(x["VS"]), heads)
    assert got.dtype == BF and got.shape == (3, 7, 16)
    np.testing.assert_allclose(f32(got), f32(jsam._heads_diag_out(want, heads, 4)),
                               atol=KERNEL_ATOL, rtol=0)


@pytest.mark.parametrize("ranks,scaled,with_a", [((), (), False),
                                                 ((9, 2), (True, False), True)])
def test_i2t_scores_bf16_plain_matches_pallas(ranks, scaled, with_a):
    heads = 4
    blocks, x = _state(np.random.RandomState(8), ranks or (1,), scaled or (False,))
    blocks = blocks if ranks else ()
    a = x["a"] if with_a else None
    uq = x["UK"] if ranks else None
    kbT = jsam._heads_block_q(jnp.asarray(x["q"]), heads, 4)
    with pltpu.force_tpu_interpret_mode():
        want = jfac.factored_i2t_scores(kbT, j16(uq), _blocks(blocks, j16), j16(a),
                                        jnp.asarray(x["KS"]), jnp.asarray(x["KC"]), heads)
    got = factored.factored_i2t_scores(t16(x["q"]), t16(uq), _blocks(blocks, t16), t16(a),
                                       t16(x["KS"]), t16(x["KC"]), heads)
    assert got.dtype == BF and got.shape == (3, 4 * 7 + 1, 40)
    np.testing.assert_allclose(f32(got), f32(want), atol=KERNEL_ATOL, rtol=0)


def test_scaled_rows_split_exactly_into_two_bf16():
    """tilde = Pd * s of two bf16 values has at most 16 significant bits, so
    hi = bf16(tilde) and lo = bf16(tilde - hi) hold it exactly (the bf16
    K2 entry forms a scaled block past the first as hi^T U + lo^T U), over
    wide exponents, for both signs and at the rounding ties."""
    rng = np.random.RandomState(9)
    n = 1 << 16
    pd = torch.from_numpy(rng.randn(n).astype(np.float32) * np.exp2(rng.randint(-40, 40, n))
                          ).to(BF)
    s = torch.from_numpy(rng.randn(n).astype(np.float32) * np.exp2(rng.randint(-40, 40, n))
                         ).to(BF)
    # bf16 values with 8 significant bits each whose product lands on a tie
    ties = torch.tensor([1 + 2 ** -7, 1 + 3 * 2 ** -7, -(1 + 2 ** -7)], dtype=BF)
    pd = torch.cat([pd, ties])
    s = torch.cat([s, ties])
    tilde = pd.float() * s.float()
    assert torch.equal(tilde.double(), pd.double() * s.double())   # exact in fp32
    hi = tilde.to(BF)
    lo = (tilde - hi.float()).to(BF)
    assert torch.equal(hi.float() + lo.float(), tilde)
    assert torch.equal(hi.double() + lo.double(), tilde.double())


def test_factored_dispatches_refuse_float16_and_mixed_dtypes():
    B, N, C, d, T, heads = 1, 8, 256, 128, 7, 8
    blocks = ((torch.rand(B, 3, N), torch.rand(B, N)),)
    U, S, a = torch.randn(B, 3, C), torch.randn(N, C), torch.rand(B, N)
    q, UK = torch.randn(B, T, d), torch.randn(B, 3, d)
    KS = torch.randn(N, d)

    def cast(dt):
        return (tuple((p.to(dt), s.to(dt)) for p, s in blocks), U.to(dt), S.to(dt),
                a.to(dt), q.to(dt), UK.to(dt), KS.to(dt))

    for dt in (torch.float16, torch.float64):
        bl, u, s_, a_, q_, uk, ks = cast(dt)
        with pytest.raises(ValueError):
            factored.factored_ln_stats(bl, u, s_, a_)
        with pytest.raises(ValueError):
            factored.factored_t2i_attention(q_, uk, uk, bl, a_, ks, ks, ks, heads)
        with pytest.raises(ValueError):
            factored.factored_i2t_scores(q_, uk, bl, a_, ks, ks, heads)
    bl16, u16, s16, a16, q16, uk16, ks16 = cast(BF)
    with pytest.raises(ValueError):
        factored.factored_ln_stats(bl16, U, s16, a16)                    # fp32 U
    with pytest.raises(ValueError):
        factored.factored_ln_stats(blocks, u16, s16, a16)                # fp32 blocks
    with pytest.raises(ValueError):
        factored.factored_t2i_attention(q16, uk16, uk16, bl16, a, ks16, ks16, ks16, heads)
    with pytest.raises(ValueError):
        factored.factored_i2t_scores(q16, uk16, bl16, a16, KS, ks16, heads)
    # one dtype throughout goes through, in either dtype
    assert factored.factored_i2t_scores(q16, uk16, bl16, a16, ks16, ks16, heads).dtype == BF
    assert factored.factored_i2t_scores(q, UK, blocks, a, KS, KS, heads).dtype == torch.float32
