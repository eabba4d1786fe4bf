"""Optimizer states to and from bundles (``instag_torch/io/checkpoints.py``)
against the JAX package's optax states and ``restore_like``
(instag_tpu/io/checkpoints.py, instag_tpu/train/optim.py).

Each network (the face UMF and the face and mouth PMFs, with deepspeech
audio) starts from one seeded flax tree on both sides and takes the same
seeded gradients. In one direction, the JAX optimizer takes three updates,
its state goes through ``save_bundle`` / ``load_bundle`` into the port's
optimizer, and both take a fourth; in the other, the port takes the three,
its state dict goes through the port's bundle into ``restore_like``, and
both take the fourth. The UMF's schedule is also restored at count 150 of
a 300-step run (warm step 100), past its 0.1x warm phase.

Tolerances: parameters after the fourth step within rtol 1e-5 (plus an
atol of 1e-6 for the hash tables' near-zero entries); the restored rates
equal to JAX's schedule within rtol 1e-6; the Gaussian Adam state
bit-equal through both packages' bundles; bundles of the same state byte
for byte equal.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
from flax import serialization as fser

from instag_tpu.bench_utils import synthetic_state as j_state
from instag_tpu.io import checkpoints as JC
from instag_tpu.models import gaussians as JG
from instag_tpu.train import optim as JO
from instag_torch.io import checkpoints as TC
from instag_torch.io import msgpack
from instag_torch.io.from_jax import load_motion_net, motion_state_dict
from instag_torch.models import motion as TM
from instag_torch.train import optim as TO
from tests.test_torch_motion import flax_tree
from tests.torch_cpu import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
NETS = {"umf": lambda: TM.MotionNetwork(),
        "face_pmf": lambda: TM.PersonalizedMotionNetwork("face"),
        "mouth_pmf": lambda: TM.PersonalizedMotionNetwork("mouth")}
TOTAL, WARM = 300, 100


def _grads(tree, rng):
    return jax.tree.map(
        lambda v: rng.normal(0.0, 1e-2, np.shape(v)).astype(np.float32),
        tree)


def _jax_opt(kind, params):
    if kind == "umf":
        return JO.umf_optimizer(params, total_iters=TOTAL, warm_step=WARM)
    return JO.pmf_optimizer(params)


class _Port:
    """A port network and its optimizer (and the UMF's scheduler)."""

    def __init__(self, kind, params):
        self.kind = kind
        self.net = load_motion_net(NETS[kind](), params, device="cpu")
        if kind == "umf":
            self.opt, self.sched = TO.umf_optimizer(
                self.net, total_iters=TOTAL, warm_step=WARM)
        else:
            self.opt, self.sched = TO.pmf_optimizer(self.net), None

    def step(self, grads):
        g = motion_state_dict(grads)
        for name, p in self.net.named_parameters():
            p.grad = g[name].clone()
        self.opt.step()
        if self.sched is not None:
            self.sched.step()

    def to_dict(self):
        if self.kind == "umf":
            return TC.umf_opt_to_dict(self.net, self.opt, self.sched)
        return TC.pmf_opt_to_dict(self.net, self.opt)

    def restore(self, d):
        if self.kind == "umf":
            TC.restore_umf_opt(self.net, self.opt, self.sched, d)
        else:
            TC.restore_pmf_opt(self.net, self.opt, d)


@functools.partial(jax.jit, static_argnums=0)
def _jax_step(tx, state, params, grads):
    # under one jit: eager JAX dispatches each leaf's update on its own
    updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                               params)
    return optax.apply_updates(params, updates), state


def _close(net, params):
    want = motion_state_dict(jax.device_get(params))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def _bundle_roundtrip(tmp_path, tree, writer):
    path = str(tmp_path / "opt.pkl")
    writer(path, tree)
    return JC.load_bundle(path)


@pytest.mark.parametrize("kind", list(NETS))
def test_jax_state_resumes_in_the_port(kind, tmp_path):
    rng = np.random.default_rng(3)
    params = flax_tree(NETS[kind](), np.random.default_rng(10))
    grads = [_grads(params, rng) for _ in range(4)]
    tx, state = _jax_opt(kind, params)
    j_params = jax.tree.map(jnp.asarray, params)
    for g in grads[:3]:
        j_params, state = _jax_step(tx, state, j_params, g)
    d = _bundle_roundtrip(tmp_path, {"s": state}, JC.save_bundle)["s"]

    port = _Port(kind, jax.device_get(j_params))
    port.restore(d)
    # the restored state writes the JAX package's bytes back
    assert msgpack.packb(TC._state_dict_tree(port.to_dict())) == \
        fser.msgpack_serialize(fser.to_state_dict(jax.device_get(state)))
    port.step(grads[3])
    j_params, _ = _jax_step(tx, state, j_params, grads[3])
    _close(port.net, j_params)


@pytest.mark.parametrize("kind", list(NETS))
def test_port_state_resumes_in_jax(kind, tmp_path):
    rng = np.random.default_rng(4)
    params = flax_tree(NETS[kind](), np.random.default_rng(11))
    grads = [_grads(params, rng) for _ in range(4)]
    port = _Port(kind, params)
    for g in grads[:3]:
        port.step(g)
    d = _bundle_roundtrip(tmp_path, {"s": port.to_dict()},
                          TC.save_bundle)["s"]
    j_params = jax.tree.map(jnp.asarray, TC.flax_params(port.net))
    tx, state = _jax_opt(kind, j_params)
    state = JC.restore_like(state, d)
    assert int(state.inner_states["net"].inner_state[0].count) == 3
    att = state.inner_states["audio_att"].inner_state
    assert int(att[0 if kind == "umf" else 1].count) == 3
    j_params, _ = _jax_step(tx, state, j_params, grads[3])
    port.step(grads[3])
    _close(port.net, j_params)


def test_umf_schedule_restored_past_warm_phase(tmp_path):
    """A JAX state at count 150 of 300 (warm step 100): every group's rate
    stands at base x 0.5 ** (150 / 300), where a scheduler built afresh
    stands at 0.1 x base, and the next step matches JAX's."""
    rng = np.random.default_rng(5)
    params = flax_tree(TM.MotionNetwork(), np.random.default_rng(12))
    grads = [_grads(params, rng) for _ in range(2)]
    tx, state = _jax_opt("umf", params)
    j_params = jax.tree.map(jnp.asarray, params)
    j_params, state = _jax_step(tx, state, j_params, grads[0])
    d = fser.to_state_dict(jax.device_get(state))
    for label in d["inner_states"].values():
        for i in ("0", "2"):
            label["inner_state"][i]["count"] = np.asarray(150, np.int32)
    state = JC.restore_like(state, d)

    port = _Port("umf", jax.device_get(j_params))
    fresh = [g["lr"] for g in port.opt.param_groups]
    port.restore(d)
    mult = float(JO.umf_schedule(TOTAL, WARM)(150))
    assert mult == pytest.approx(0.5 ** 0.5, rel=1e-6)
    for group, base, lr0 in zip(port.opt.param_groups, port.sched.base_lrs,
                                fresh):
        assert group["lr"] == pytest.approx(base * mult, rel=1e-6)
        assert lr0 == pytest.approx(base * 0.1, rel=1e-6)
    assert port.sched.last_epoch == 150
    assert all(int(st["step"]) == 150 for st in port.opt.state.values())
    port.step(grads[1])
    j_params, _ = _jax_step(tx, state, j_params, grads[1])
    _close(port.net, j_params)
    assert port.sched.last_epoch == 151


def test_restore_refuses_a_mismatched_state():
    params = flax_tree(TM.PersonalizedMotionNetwork("face"),
                       np.random.default_rng(13))
    _, state = _jax_opt("pmf", params)
    d = fser.to_state_dict(jax.device_get(state))
    port = _Port("mouth_pmf", flax_tree(TM.PersonalizedMotionNetwork(
        "mouth"), np.random.default_rng(13)))
    with pytest.raises(ValueError, match="do not match"):
        port.restore(d)


def test_gopt_round_trip_is_bit_equal(tmp_path):
    s = j_state(300, 512, seed=1, spread=0.2, scale=0.02)
    opt = JG.adam_init(s.params)
    rng = np.random.default_rng(6)
    for _ in range(2):
        g = jax.tree.map(lambda v: jnp.asarray(
            rng.normal(size=v.shape).astype(np.float32)), s.params)
        _, opt = JG.adam_update(s.params, g, opt, {
            k: 1e-3 for k in s.params.__dataclass_fields__}, s.alive)
    path = str(tmp_path / "g.pkl")
    JC.save_bundle(path, {"gopt": opt})
    loaded = JC.load_bundle(path)["gopt"]
    ours = TC.gopt_from_dict(loaded, device="cpu")
    assert ours.step == 2
    for f in ours.mu.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(ours.mu, f).numpy(),
                                      np.asarray(getattr(opt.mu, f)))
        np.testing.assert_array_equal(getattr(ours.nu, f).numpy(),
                                      np.asarray(getattr(opt.nu, f)))
    # back through the port's bundle, into the JAX AdamState, bit for bit
    TC.save_bundle(path, {"gopt": TC.gopt_to_dict(ours)})
    with open(path, "rb") as f:
        assert f.read() == fser.msgpack_serialize(
            fser.to_state_dict(jax.device_get({"gopt": opt})))
    back = JC.restore_like(opt, JC.load_bundle(path)["gopt"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(opt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_flax_trees_are_copies_of_the_nets():
    """A flax tree (of parameters or of optimizer moments) taken from a
    network on the CPU does not change when the network trains on: numpy
    would share the tensors' memory, and JAX may read it later."""
    port = _Port("mouth_pmf", flax_tree(TM.PersonalizedMotionNetwork(
        "mouth"), np.random.default_rng(14)))
    grads = _grads(TC.flax_params(port.net), np.random.default_rng(15))
    port.step(grads)
    trees = [TC.flax_params(port.net), port.to_dict()]
    before = jax.tree.map(np.copy, trees)
    port.step(grads)
    for a, b in zip(jax.tree.leaves(trees), jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)
