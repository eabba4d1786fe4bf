"""Densification and the capacity resize on the card against the CPU, without
JAX, so that the cases marked ``cuda`` also run on a machine that has a card
and no JAX:

    python -m pytest tests/test_torch_gaussians_card.py -m cuda --noconftest -q

``densify_and_prune`` on the card, given the same split draws, must give the
CPU's alive mask and dropped count, equal Adam moments and parameters
within rtol 1e-6 and atol 1e-6 (the children's positions go through a
matmul and their scales through log/expm1, whose last bits may differ
between the two devices). ``pack_resize`` must keep every live slot's
parameters and moments, bit for bit, on either device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from instag_torch.bench_utils import synthetic_state
from instag_torch.models import gaussians as G

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(name)


def _cloud(n=300, cap=512, seed=0):
    """A CPU cloud with dead slots among the live ones, scales on both
    sides of the clone / split boundary (percent_dense 0.005 x extent 2),
    random rotations and opacities, densification statistics about 70 %
    above the gradient threshold 2e-4, random Adam moments, and the split
    draws."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    state = synthetic_state(cap, cap, seed=seed, spread=0.5, device="cpu")
    scal = rng.uniform(0.002, 0.03, (cap, 3))
    params = dataclasses.replace(
        state.params, scaling=t(scal + np.log(-np.expm1(-scal))),
        rotation=t(rng.normal(size=(cap, 4))),
        opacity=t(rng.normal(0, 2, (cap, 1))),
        features_rest=t(rng.normal(0, 0.1, (cap, 3, 3))))
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n]] = True
    denom = rng.integers(0, 6, cap)
    state = state.replace(params=params, alive=torch.from_numpy(alive),
                          denom=t(denom),
                          xyz_grad_accum=t(denom * rng.uniform(0, 6.5e-4,
                                                                cap)),
                          max_radii2d=t(rng.uniform(0, 40, cap)))
    opt = G.AdamState(*(G._map_params(lambda x: t(rng.normal(
        0, s, x.shape)), params) for s in (1e-3, 1e-6)), step=5)
    noise = t(rng.normal(size=(2, cap, 3)))
    return state, opt, noise


@pytest.mark.cuda
@pytest.mark.parametrize("n,max_screen", [(300, None), (480, 20.0)])
def test_densify_and_prune_on_card_matches_cpu(n, max_screen):
    dev = _device("cuda")
    state, opt, noise = _cloud(n)
    args = (2e-4, 0.3, 2.0, max_screen, 0.005)
    c_state, c_opt = G.densify_and_prune(state, opt, noise, *args)
    g_state, g_opt = G.densify_and_prune(state.to(dev), opt.to(dev),
                                         noise.to(dev), *args)
    assert torch.equal(g_state.alive.cpu(), c_state.alive)
    assert g_state.dropped_children == c_state.dropped_children
    assert int((c_state.alive & ~state.alive).sum()) > 20
    for f in G.PARAM_FIELDS:
        torch.testing.assert_close(getattr(g_state.params, f).cpu(),
                                   getattr(c_state.params, f), rtol=1e-6,
                                   atol=1e-6, msg=f)
        for m in ("mu", "nu"):
            assert torch.equal(getattr(getattr(g_opt, m), f).cpu(),
                               getattr(getattr(c_opt, m), f)), (m, f)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("new_cap,keep_slots", [(256, False), (1024, False),
                                                (1024, True)])
def test_pack_resize_keeps_live_slots(device, new_cap, keep_slots):
    dev = _device(device)
    state, opt, _ = _cloud(200)
    new, new_opt = G.pack_resize(state.to(dev), opt.to(dev), new_cap,
                                 keep_slots=keep_slots)
    live = state.alive
    n = int(live.sum())
    # packed: the live slots in index order at the front; kept: in place
    dest = (torch.arange(n) if not keep_slots
            else torch.nonzero(live)[:, 0])
    alive = new.alive.cpu()
    assert new.capacity == new_cap and int(alive.sum()) == n
    assert alive[dest].all()
    for f in G.PARAM_FIELDS:
        for ours, ref in ((new.params, state.params), (new_opt.mu, opt.mu),
                          (new_opt.nu, opt.nu)):
            assert torch.equal(getattr(ours, f).cpu()[dest],
                               getattr(ref, f)[live]), f
    for k in ("denom", "xyz_grad_accum", "max_radii2d"):
        assert torch.equal(getattr(new, k).cpu()[dest],
                           getattr(state, k)[live]), k
    assert new_opt.step == opt.step
