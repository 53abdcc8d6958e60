"""The port's PEM training path against the JAX package on the CPU, at
tests/test_trainer.py's tiny_full_cfg() widths and batch 2: the schedule,
the losses (an argmin tie included), the deterministic half of
aug_pose_noise on JAX's own draws, BatchNorm in train mode, train_forward,
one PEMTrainer step (loss, metrics, every gradient by name, the BatchNorm
running statistics, the Adam moments and update), Adam + WarmupCosine on
its own, the checkpoint round trip, load_partial, the MAE backbone loader,
PrefetchLoader, the profiling helpers and the ViT remat lever.

The JAX step runs eagerly (`_step_impl`, once per module): under jit XLA
folds the `cos_v + 0.0` of the JAX structure embedding, which turns a -0.0
on its diagonal into a wedge angle of pi (tests/test_torch_port_pem_slice.py);
the port follows the eager path. JAX's gradients are read from the step
itself: its optax chain gets a first link that keeps the incoming updates
(the gradients) as its state.

Tolerances (beyond the atol = rtol = 1e-4 of torch_port_common):
- gradients, per tensor: atol = 1e-3 x the tensor's largest |g| + 1e-7.
  float32 sums in another order move the forward by ~1e-6 relative; the
  backward of the fine matcher's focused linear attention (features to the
  power 3) carries that to ~1.6e-4 of a tensor's scale (observed). The
  1e-7 floor covers gradients that are 0 in exact arithmetic (a key bias
  under the softmax), where both packages leave ~1e-8 of rounding.
- BatchNorm running statistics: atol = rtol = 1e-5 (observed <= 7e-7).
  The biased variance flax keeps and torch's unbiased one differ by
  1/(N-1) of the batch's variance, only ~1e-5 at the step's N = 1536, so
  the dedicated BatchNorm test holds the update at N = 24 (4%).
- Adam: the first moment as the gradients, the second (g^2, which doubles
  a relative error) at 2e-3 of its scale; the new parameters within two
  float32 ulps of the parameter plus 1e-3 of lr where |g| >= 1e-4 (the
  first step's lr, 1e-7, is below a parameter's ulp, so the step itself is
  rounded away in part), and within two ulps plus lr elsewhere (there |g|
  is within a few eps = 1e-6 and the step g / (|g| + eps) turns with the
  gradient's last bits). The update formula alone is held to optax's at
  rtol 1e-6 by test_adam_with_warmup_cosine_matches_optax.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from sam6d_tpu.core.config import TrainConfig
from sam6d_tpu.data.prefetch import PrefetchLoader as JaxPrefetchLoader
from sam6d_tpu.parallel.mesh import make_mesh
from sam6d_tpu.train import losses as jax_losses
from sam6d_tpu.train.lr_schedule import warmup_cosine as jax_warmup_cosine
from sam6d_tpu.train.trainer import PEMTrainer as JaxTrainer
from sam6d_tpu.train.trainer import TrainState as JaxState
from sam6d_tpu.train.trainer import aug_pose_noise as jax_aug_pose_noise
from sam6d_tpu.weights.convert_pem import convert_mae_vit
from sam6d_tpu.weights.partial import load_partial as jax_load_partial
from sam6d_torch.core.checkpoint import (latest_checkpoint, load_train_state,
                                         save_train_state)
from sam6d_torch.core.profiling import LogBuffer, StageTimer
from sam6d_torch.data.prefetch import PrefetchLoader
from sam6d_torch.models.fine_matching import _BNLayer
from sam6d_torch.models.vit import ViTEncoder
from sam6d_torch.train import losses
from sam6d_torch.train.lr_schedule import warmup_cosine
from sam6d_torch.train.trainer import (STD_ROTS, PEMTrainer, PoseNoise,
                                       apply_pose_noise, aug_pose_noise,
                                       batch_to_device, draw_pose_noise,
                                       make_dummy_batch)
from sam6d_torch.weights.partial import load_partial
from sam6d_torch.weights.pem import mae_vit_state_dict, pem_state_dict_from_flax

from tests.test_trainer import tiny_full_cfg
from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import close, jax_variables, torch_net

B = 2
STATS_TOL = 1e-5


def _batch(cfg, seed=3):
    """make_dummy_batch, with a second template view of its own points (the
    dummy batch repeats the first view; two views of an object differ)."""
    rng = np.random.RandomState(seed)
    batch = make_dummy_batch(cfg, B, rng)
    batch["tem2_pts"] = (rng.rand(*batch["tem2_pts"].shape).astype(np.float32) - 0.5) * 0.2
    return batch


def _jax_draws(key, B, std_rots=STD_ROTS):
    """The draws JAX's aug_pose_noise makes from `key`, as a PoseNoise."""
    k1, k2, k3 = jax.random.split(key, 3)
    std = jax.random.choice(k1, jnp.asarray(std_rots))
    return PoseNoise(torch.tensor(np.asarray(std)),
                     torch.tensor(np.asarray(jax.random.normal(k2, (B, 3)))),
                     torch.tensor(np.asarray(jax.random.normal(k3, (B, 3)))))


@pytest.fixture(scope="module")
def step():
    """One eager JAX PEMTrainer step and one port step from the same
    weights, batch and pose-noise draws."""
    cfg = tiny_full_cfg()
    _, variables = jax_variables(cfg.pem)
    batch = _batch(cfg)
    key = jax.random.PRNGKey(5)

    jt = JaxTrainer(cfg, make_mesh(1, dp=1))
    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    jt.tx = optax.chain(keep_grads, jt.tx)
    params = variables["params"]
    jstate = JaxState(params, variables["batch_stats"], jt.tx.init(params),
                      jnp.zeros((), jnp.int32))
    new, jmetrics = jt._step_impl(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    trainer = PEMTrainer(cfg, device="cpu")
    state = trainer.init_state(state_dict=pem_state_dict_from_flax(variables))
    before = {k: v.clone() for k, v in state.net.state_dict().items()}
    state, metrics = trainer.step(state, batch_to_device(batch, "cpu"),
                                  noise=_jax_draws(key, B))
    adam = new.opt_state[1][0]
    return dict(
        cfg=cfg, trainer=trainer, state=state, metrics=metrics, before=before,
        jmetrics=jmetrics, lr0=trainer.schedule(0),
        jgrads=pem_state_dict_from_flax({"params": new.opt_state[0],
                                         "batch_stats": new.batch_stats}),
        jnew=pem_state_dict_from_flax({"params": new.params,
                                       "batch_stats": new.batch_stats}),
        jmu=pem_state_dict_from_flax({"params": adam.mu, "batch_stats": new.batch_stats}),
        jnu=pem_state_dict_from_flax({"params": adam.nu, "batch_stats": new.batch_stats}),
        jcount=int(adam.count))


def _close_scaled(got, want, name, rel=1e-3, floor=1e-7):
    want = want.detach().double()
    bound = rel * float(want.abs().max()) + floor
    err = float((got.detach().double() - want).abs().max())
    assert err <= bound, f"{name}: max abs diff {err:.3g} > {bound:.3g}"


# ------------------------------------------------------------------ schedule

@pytest.mark.parametrize("k", [0, 1, 500, 999, 1000, 1001, 300_000, 599_999, 600_000, 700_000])
def test_warmup_cosine_matches_optax(k):
    """The first step (lr * warmup_factor), the warm-up's end, the cosine
    and its last step; float32 (optax) vs float64 (port) rounding of
    1e-4-scale values: atol 1e-10 (~1e-6 of lr)."""
    t = TrainConfig()
    args = (t.lr, t.max_iters, t.warmup_iters, t.warmup_factor)
    np.testing.assert_allclose(warmup_cosine(*args)(k), float(jax_warmup_cosine(*args)(k)),
                               rtol=1e-6, atol=1e-10)


def test_lambda_lr_runs_step_k_at_schedule_k():
    """As optax evaluates the schedule at the count before its increment,
    update k runs at schedule(k): the first at lr * warmup_factor."""
    cfg = tiny_full_cfg()
    trainer = PEMTrainer(cfg, device="cpu")
    p = torch.nn.Parameter(torch.zeros(3))
    t = cfg.train
    opt = torch.optim.Adam([p], lr=t.lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: trainer.schedule(s) / t.lr)
    for k in range(12):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], trainer.schedule(k), rtol=1e-12)
        opt.step()
        sched.step()
    assert trainer.schedule(0) == pytest.approx(t.lr * t.warmup_factor)


# -------------------------------------------------------------------- losses

def test_correspondence_loss_and_its_gradient_match_jax():
    rng = np.random.RandomState(0)
    N1, N2 = 30, 40
    att = [rng.randn(B, N1 + 1, N2 + 1).astype(np.float32) * 3 for _ in range(2)]
    p1 = rng.rand(B, N1, 3).astype(np.float32)
    p2 = rng.rand(B, N2, 3).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    t = rng.rand(B, 3).astype(np.float32) * 0.1

    def jax_loss(a):
        ep = jax_losses.compute_correspondence_loss(
            a, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(R), jnp.asarray(t), 0.15, "fine")
        return jax_losses.total_loss(ep, 100.0)

    (jl, jm), jg = jax.value_and_grad(jax_loss, has_aux=True)([jnp.asarray(a) for a in att])
    ta = [torch.tensor(a, requires_grad=True) for a in att]
    ep = losses.compute_correspondence_loss(ta, torch.tensor(p1), torch.tensor(p2),
                                            torch.tensor(R), torch.tensor(t), 0.15, "fine")
    loss, m = losses.total_loss(ep, 100.0)
    loss.backward()
    assert set(m) == set(jm)
    for k in m:
        close(m[k], jm[k])
    for a, g in zip(ta, jg):
        close(a.grad, g, atol=1e-7)


def test_total_loss_clamps_per_sample():
    ep = {"a_loss0": torch.tensor([150.0, 2.0], requires_grad=True)}
    loss, _ = losses.total_loss(ep, 100.0)
    jl, _ = jax_losses.total_loss({"a_loss0": jnp.asarray([150.0, 2.0])}, 100.0)
    assert float(loss.detach()) == float(jl) == 51.0
    loss.backward()
    np.testing.assert_array_equal(ep["a_loss0"].grad.numpy(), [0.0, 0.5])


def test_correspondence_labels_give_a_tie_to_the_first_index():
    """An observed point exactly between two template points, and a
    template point exactly between two observed points: both packages
    label the first of the two."""
    pts1 = np.array([[[0, 0, 0], [0.05, 0.3, 0], [-0.05, 0.3, 0]]], np.float32)
    pts2 = np.array([[[0.05, 0, 0], [-0.05, 0, 0], [0, 0.3, 0]]], np.float32)
    R = np.eye(3, dtype=np.float32)[None]
    t = np.zeros((1, 3), np.float32)
    l1, l2, _ = losses.correspondence_labels(torch.tensor(pts1), torch.tensor(pts2),
                                             torch.tensor(R), torch.tensor(t), 0.15)
    jl1, jl2, _ = jax_losses.correspondence_labels(jnp.asarray(pts1), jnp.asarray(pts2),
                                                   jnp.asarray(R), jnp.asarray(t), 0.15)
    np.testing.assert_array_equal(l1.numpy(), np.asarray(jl1))
    np.testing.assert_array_equal(l2.numpy(), np.asarray(jl2))
    assert l1[0, 0] == 1 and l2[0, 2] == 2     # first index + 1 (0 is the background)


# ---------------------------------------------------------------- pose noise

@pytest.mark.parametrize("std_rots,max_rot", [(STD_ROTS, 45.0), ((60.0, 90.0), 45.0)])
def test_apply_pose_noise_on_jax_draws_matches_jax(std_rots, max_rot):
    """The deterministic half fed the draws JAX makes from the same key
    (split, choice, normal, normal); the second case clamps the angles."""
    rng = np.random.RandomState(2)
    gt_R = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(16)]).astype(np.float32)
    gt_t = (rng.rand(16, 3).astype(np.float32) - 0.5) * np.array([1, 1, 0.2], np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jR, jt = jax_aug_pose_noise(key, jnp.asarray(gt_R), jnp.asarray(gt_t),
                                    std_rots=std_rots, max_rot=max_rot)
        R, t = apply_pose_noise(torch.tensor(gt_R), torch.tensor(gt_t),
                                _jax_draws(key, 16, std_rots), max_rot=max_rot)
        close(R, jR, atol=1e-6, rtol=1e-6)
        close(t, jt, atol=1e-6, rtol=1e-6)
        assert (t[:, 2] > 0).all()


def test_aug_pose_noise_is_its_draws_then_the_deterministic_half():
    a = draw_pose_noise(5, torch.Generator().manual_seed(3))
    b = draw_pose_noise(5, torch.Generator().manual_seed(3))
    assert float(a.std) in STD_ROTS and a.rot.shape == a.trans.shape == (5, 3)
    for x, y in ((a.std, b.std), (a.rot, b.rot), (a.trans, b.trans)):
        assert torch.equal(x, y)
    R = torch.eye(3).expand(5, 3, 3)
    t = torch.tensor([[0.0, 0.0, 0.5]]).expand(5, 3)
    for x, y in zip(aug_pose_noise(R, t, torch.Generator().manual_seed(3)),
                    apply_pose_noise(R, t, a)):
        assert torch.equal(x, y)


# ------------------------------------------------------------------- modules

def test_batchnorm_train_mode_matches_flax():
    """Channels-last train-mode BN on (2, 3, 4, 5): output, input gradient
    and the new running statistics (flax's biased variance: N = 24, so
    torch's unbiased one would be 4% off) against flax BatchNorm(momentum
    0.9, epsilon 1e-5)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 4, 5) * 2 + 1).astype(np.float32)
    scale = rng.rand(5).astype(np.float32) + 0.5
    bias = rng.randn(5).astype(np.float32)
    mean0 = rng.randn(5).astype(np.float32)
    var0 = rng.rand(5).astype(np.float32) + 0.5
    bn = nn.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}

    def f(xx):
        y, mut = bn.apply(v, xx, use_running_average=False, mutable=["batch_stats"])
        return (y * y).sum(), (y, mut)

    (_, (jy, mut)), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    layer = _BNLayer(5)
    with torch.no_grad():
        layer.bn.weight.copy_(torch.tensor(scale))
        layer.bn.bias.copy_(torch.tensor(bias))
        layer.bn.running_mean.copy_(torch.tensor(mean0))
        layer.bn.running_var.copy_(torch.tensor(var0))
    tx = torch.tensor(x, requires_grad=True)
    y = layer(tx, train=True)
    (y * y).sum().backward()
    close(y, jy, atol=1e-5, rtol=1e-5)
    close(tx.grad, jg, atol=1e-4, rtol=1e-4)
    close(layer.bn.running_mean, mut["batch_stats"]["mean"], atol=1e-6, rtol=1e-6)
    close(layer.bn.running_var, mut["batch_stats"]["var"], atol=1e-6, rtol=1e-6)
    # eval mode reads the running statistics
    close(layer(tx), bn.apply({"params": v["params"], "batch_stats": mut["batch_stats"]},
                              jnp.asarray(x), use_running_average=True))


def test_train_forward_matches_jax():
    """Every block's coarse and fine similarities, the aux clouds and the
    BatchNorm statistics the two positional encodings move, from one pose."""
    cfg = tiny_full_cfg()
    jnet, variables = jax_variables(cfg.pem)
    net = torch_net(cfg.pem, variables)
    batch = _batch(cfg, seed=7)
    rng = np.random.RandomState(1)
    R = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(B)]).astype(np.float32)
    t = rng.randn(B, 3).astype(np.float32) * 0.2 + np.array([0, 0, 2.5], np.float32)
    (jc, jf, jaux), mut = jnet.apply(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(R),
        jnp.asarray(t), method="train_forward", mutable=["batch_stats"])
    c, f, aux = net.train_forward(batch_to_device(batch, "cpu"), torch.tensor(R),
                                  torch.tensor(t))
    assert len(c) == len(jc) == cfg.pem.coarse.nblock
    assert len(f) == len(jf) == cfg.pem.fine.nblock
    for a, b in zip(c + f, list(jc) + list(jf)):
        close(a, b)
    for k in jaux:
        close(aux[k], jaux[k], atol=1e-6, rtol=1e-6)
    want = pem_state_dict_from_flax({"params": variables["params"],
                                     "batch_stats": mut["batch_stats"]})
    moved = [n for n, _ in net.named_buffers() if "running" in n]
    assert len(moved) == 12
    for n, buf in net.named_buffers():
        if "running" in n:
            close(buf, want[n], atol=STATS_TOL, rtol=STATS_TOL)


# ------------------------------------------------------------------ the step

def test_trainer_step_loss_and_metrics_match_jax(step):
    m, jm = step["metrics"], step["jmetrics"]
    assert set(m) == set(jm)
    assert any(k.startswith("fine_loss") for k in m)
    for k in m:
        close(m[k], jm[k])
    assert step["state"].step == 1


def test_trainer_step_gradients_match_jax(step):
    net, jg = step["state"].net, step["jgrads"]
    names = [n for n, _ in net.named_parameters()]
    assert set(names) <= set(jg) and len(names) > 100
    for n, p in net.named_parameters():
        assert p.grad is not None, f"{n} got no gradient"
        _close_scaled(p.grad, jg[n], n)


def test_trainer_step_batchnorm_statistics_match_jax(step):
    """Both positional encodings move the statistics, with flax's biased
    variance; num_batches_tracked counts the two train-mode calls."""
    new, before = step["jnew"], step["before"]
    for n, buf in step["state"].net.named_buffers():
        if "running" in n:
            assert not torch.equal(buf, before[n])
            close(buf, new[n], atol=STATS_TOL, rtol=STATS_TOL)
        elif n.endswith("num_batches_tracked"):
            assert int(buf) == 2


def test_trainer_step_adam_update_matches_optax(step):
    state, jg, lr0 = step["state"], step["jgrads"], step["lr0"]
    b1, b2 = step["cfg"].train.betas
    assert step["jcount"] == 1
    adam = state.optimizer.state
    for n, p in state.net.named_parameters():
        s = adam[p]
        assert int(s["step"]) == 1
        _close_scaled(s["exp_avg"], step["jmu"][n], n, floor=(1 - b1) * 1e-7)
        _close_scaled(s["exp_avg_sq"], step["jnu"][n], n, rel=2e-3,
                      floor=(1 - b2) * 1e-14)
        got, want = p.detach().numpy(), step["jnew"][n].numpy()
        ulp2 = 2 * np.spacing(np.maximum(np.abs(got), np.abs(want)))
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= ulp2 + lr0).all(), n
        big = jg[n].abs().numpy() >= 1e-4
        assert (err[big] <= ulp2[big] + 1e-3 * lr0).all(), n
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(step["trainer"].schedule(1))


def test_adam_with_warmup_cosine_matches_optax():
    """torch Adam + LambdaLR(warmup_cosine) against optax.adam(warmup_cosine)
    on the same gradients for 6 steps across the warm-up's end."""
    rng = np.random.RandomState(0)
    t = TrainConfig(lr=1e-2, max_iters=10, warmup_iters=3)
    p0 = rng.randn(7, 5).astype(np.float32)
    grads = [rng.randn(7, 5).astype(np.float32) * 10 ** rng.uniform(-3, 0) for _ in range(6)]
    tx = optax.adam(jax_warmup_cosine(t.lr, t.max_iters, t.warmup_iters, t.warmup_factor),
                    b1=t.betas[0], b2=t.betas[1], eps=t.eps)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.tensor(p0))
    sched = warmup_cosine(t.lr, t.max_iters, t.warmup_iters, t.warmup_factor)
    opt = torch.optim.Adam([p], lr=t.lr, betas=t.betas, eps=t.eps)
    lr = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: sched(s) / t.lr)
    for g in grads:
        u, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        p.grad = torch.tensor(g)
        opt.step()
        lr.step()
        close(p, jp, atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_round_trip_and_resume(tmp_path, step):
    """save -> latest_checkpoint (highest step by name) -> load into a fresh
    state: model, BatchNorm buffers, optimizer, schedule and step equal, and
    one more step from each gives the same parameters."""
    trainer, state = step["trainer"], step["state"]
    save_train_state(str(tmp_path), 0, trainer.init_state())
    path = save_train_state(str(tmp_path), 1, state)
    assert latest_checkpoint(str(tmp_path)) == path
    assert os.path.basename(path) == "step_00000001.pt"
    assert latest_checkpoint(str(tmp_path / "none")) is None
    fresh = load_train_state(path, trainer.init_state())
    assert fresh.step == 1
    sd, fsd = state.net.state_dict(), fresh.net.state_dict()
    for k in sd:
        assert torch.equal(sd[k], fsd[k]), k
    for p, q in zip(state.net.parameters(), fresh.net.parameters()):
        a, b = state.optimizer.state[p], fresh.optimizer.state[q]
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    assert fresh.scheduler.state_dict() == state.scheduler.state_dict()
    batch = batch_to_device(_batch(step["cfg"], seed=11), "cpu")
    noise = draw_pose_noise(B, torch.Generator().manual_seed(0))
    snapshot = {k: v.clone() for k, v in state.net.state_dict().items()}
    trainer.step(fresh, batch, noise=noise)
    trainer.step(state, batch, noise=noise)
    for (k, v), w in zip(state.net.state_dict().items(), fresh.net.state_dict().values()):
        assert torch.equal(v, w), k
    state.net.load_state_dict(snapshot)


# ------------------------------------------------------------------- weights

def test_load_partial_report_matches_jax():
    rng = np.random.RandomState(0)
    target = {"a": {"w": rng.randn(3, 2), "b": rng.randn(2)}, "c": {"w": rng.randn(4)}}
    source = {"a": {"w": rng.randn(3, 2), "b": rng.randn(5)}, "d": {"w": rng.randn(4)}}

    def flat(tree):
        return {f"{k}.{j}": v for k, sub in tree.items() for j, v in sub.items()}

    jmerged, jreport = jax_load_partial(target, source)
    merged, report = load_partial({k: torch.tensor(v) for k, v in flat(target).items()},
                                  flat(source))
    assert report == {k.replace("']['", ".").strip("[']"): v for k, v in jreport.items()}
    assert report == {"a.w": "loaded", "a.b": "shape_mismatch", "c.w": "missing_in_source"}
    for k, v in flat(jmerged).items():
        np.testing.assert_array_equal(merged[k].numpy(), np.asarray(v))


def test_mae_vit_state_dict_matches_convert_mae_vit(tmp_path):
    """A reference-named MAE checkpoint (the ViT under plain names, plus MAE
    decoder keys no one reads) -> the port's ViT, equal by name to what the
    JAX package's convert_mae_vit gives its trainer."""
    cfg = tiny_full_cfg()
    _, variables = jax_variables(cfg.pem)
    net = torch_net(cfg.pem, variables)
    vit = net.feature_extraction.rgb_net.vit
    rng = np.random.RandomState(0)
    mae = {k: rng.randn(*v.shape).astype(np.float32) for k, v in vit.state_dict().items()}
    mae["decoder_embed.weight"] = rng.randn(8, 4).astype(np.float32)
    mae["mask_token"] = rng.randn(1, 1, 8).astype(np.float32)
    path = str(tmp_path / "mae.pth")
    torch.save({"model": {k: torch.tensor(v) for k, v in mae.items()}}, path)
    sd = mae_vit_state_dict(path, depth=cfg.pem.vit.depth)
    vit.load_state_dict(sd)
    params = dict(variables["params"])
    params["feature_extraction"] = dict(params["feature_extraction"],
                                        vit=convert_mae_vit(mae, depth=cfg.pem.vit.depth))
    want = pem_state_dict_from_flax({"params": params, "batch_stats": variables["batch_stats"]})
    for k, v in net.state_dict().items():
        if k.startswith("feature_extraction.rgb_net.vit."):
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    del mae["blocks.0.attn.qkv.bias"]
    with pytest.raises(KeyError):
        mae_vit_state_dict(mae, depth=cfg.pem.vit.depth)


# -------------------------------------------------------------- host helpers

def _drain(loader, n):
    out = [loader.get() for _ in range(n)]
    loader.close()
    return out


def test_prefetch_loader_seeds_each_worker_like_jax():
    """Worker i draws from RandomState(seed + i): every batch either loader
    yields is the next draw of one of those streams."""
    def make(rng):
        return int(rng.randint(1 << 30))

    streams = [np.random.RandomState(7 + i).randint(1 << 30, size=8).tolist() for i in range(2)]
    for cls in (PrefetchLoader, JaxPrefetchLoader):
        got = _drain(cls(make, num_workers=2, depth=2, seed=7), 8)
        assert all(any(v in s for s in streams) for v in got)
        for s in streams:
            seen = [v for v in got if v in s]
            assert seen == s[:len(seen)]


def test_prefetch_loader_surfaces_worker_errors_like_jax():
    """A worker's exception is raised by get(); once all workers are gone
    get() raises RuntimeError instead of blocking."""
    for cls in (PrefetchLoader, JaxPrefetchLoader):
        def make(rng):
            raise ValueError("bad shard")

        loader = cls(make, num_workers=2, depth=2, seed=1)
        with pytest.raises(ValueError, match="bad shard"):
            loader.get()
        with pytest.raises(ValueError, match="bad shard"):
            loader.get()
        with pytest.raises(RuntimeError, match="workers have exited"):
            loader.get()
        loader.close()
        assert not any(t.is_alive() for t in loader._threads)


def test_prefetch_loader_stress_more_workers_than_cores():
    """32 workers (more than the cores here) with a 1 us switch interval:
    every batch is one worker stream's next draw, and once every worker has
    raised, get() reports it instead of blocking (the live count, a shared
    read-modify-write, reaches 0). Each wait is bounded."""
    import sys
    import threading

    def run_bounded(fn, seconds=30):
        out = {}
        t = threading.Thread(target=lambda: out.update(v=fn()), daemon=True)
        t.start()
        t.join(timeout=seconds)
        assert not t.is_alive(), "PrefetchLoader blocked"
        return out["v"]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def make(rng):
            return int(rng.randint(1 << 30))

        streams = [np.random.RandomState(3 + i).randint(1 << 30, size=64).tolist()
                   for i in range(32)]
        got = run_bounded(lambda: _drain(PrefetchLoader(make, num_workers=32, depth=4,
                                                        seed=3), 64))
        for s in streams:
            seen = [v for v in got if v in s]
            assert seen == s[:len(seen)]
        assert all(any(v in s for s in streams) for v in got)

        calls = []

        def fail(rng):
            calls.append(1)
            if len(calls) > 40:
                raise ValueError("bad shard")
            return 0

        loader = PrefetchLoader(fail, num_workers=32, depth=64, seed=0)

        def until_exhausted():
            errors = 0
            while True:
                try:
                    loader.get()
                except ValueError:
                    errors += 1
                except RuntimeError:
                    return errors

        assert run_bounded(until_exhausted) == 32
        loader.close()
        assert not any(t.is_alive() for t in loader._threads)
    finally:
        sys.setswitchinterval(interval)


def test_stage_timer_and_log_buffer():
    timer = StageTimer("cpu")
    for _ in range(2):
        with timer.stage("data"):
            pass
    assert timer.counts == {"data": 2} and timer.summary()["data"] >= 0
    buf = LogBuffer()
    buf.update({"loss": torch.tensor(1.0), "acc": 0.5})
    buf.update({"loss": 3.0})
    assert buf.average() == {"loss": 2.0, "acc": 0.5}
    buf.clear()
    assert buf.average() == {}


def test_vit_remat_same_outputs_and_gradients():
    """torch.utils.checkpoint per block changes what the backward stores,
    not what it computes (the JAX package's test_remat at the same size)."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.rand(2, 32, 32, 3).astype(np.float32))
    nets = [ViTEncoder(32, 16, 32, 4, 4, out_dim=16, remat=r) for r in (False, True)]
    nets[1].load_state_dict(nets[0].state_dict())
    grads = []
    for net in nets:
        fmap, cls = net(x)
        (fmap.pow(2).sum() + cls.pow(2).sum()).backward()
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()})
    for n in grads[0]:
        close(grads[1][n], grads[0][n], atol=1e-6, rtol=1e-5)
