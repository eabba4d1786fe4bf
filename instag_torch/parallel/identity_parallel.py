"""Identity-parallel multi-identity pre-training (counterpart of
instag_tpu/parallel/identity_parallel.py): one identity a rank.

Each rank holds its identity's Gaussian cloud, Gaussian Adam state, PMF
and PMF Adam, and trains them on its own frames; the UMF is replicated:
its gradients are mean-reduced over the ranks, and every rank runs the
same AdamW step, LambdaLR and EMA (0.995) on them, so the UMF stays
bit-identical across the ranks. Each identity's loss is the serial
pre-training loss (``train.pretrain``'s face and mouth motion steps); the
contrastive hinge evaluates every other identity's PMF, whose parameters
are gathered without gradient at the start of the step (the JAX step's
``stop_gradient(pmf_all)``), and the mouth step takes JAX's rotated
partner, drawn for every identity from the shared ``rng``, under its own
face cloud. ``make_idp_densify`` draws every identity's split noise from
one generator that every rank holds and applies this rank's row, so each
identity densifies as the serial densify would on the same draws.

One step trains all n identities at once with the UMF gradient averaged,
as in the JAX package: n reference iterations with one synchronized UMF
update.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..models import gaussians as G
from .comm import all_gather, all_reduce_mean, collective_device, world


def check_identity_ranks(n_ids: int, world_size: int) -> None:
    """One rank an identity: refuse any other world size (JAX's message
    for too few devices)."""
    if world_size < n_ids:
        raise ValueError(f"identity_parallel needs >= {n_ids} devices, "
                         f"have {world_size}")
    if world_size > n_ids:
        raise ValueError(f"identity_parallel trains one identity a rank: "
                         f"{world_size} ranks for {n_ids} identities")


def stack_identities(trees):
    """The identities' trees (tensors, dicts, lists, dataclasses) stacked
    leaf by leaf on a new leading axis, as the JAX package stacks them."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return torch.stack(list(trees))
    if isinstance(t0, dict):
        return {k: stack_identities([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(stack_identities(list(x)) for x in zip(*trees))
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: stack_identities([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(t0)
            if isinstance(getattr(t0, f.name), torch.Tensor)
            or dataclasses.is_dataclass(getattr(t0, f.name))})
    return t0


def gather_tensor(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (one shape on every rank), in rank order."""
    if x.dtype == torch.bool:
        return [y.to(torch.bool) for y in all_gather(x.to(torch.uint8),
                                                      group)]
    return list(all_gather(x, group))


def gather_identities(tree, group) -> list:
    """Every rank's ``tree`` (a ``GaussianState``, an ``AdamState``, a
    tensor or a dict of them), in rank order; integer fields travel too."""
    w = world(group)[1]
    if isinstance(tree, torch.Tensor):
        return gather_tensor(tree, group)
    if isinstance(tree, dict):
        cols = {k: gather_identities(v, group) for k, v in tree.items()}
        return [{k: cols[k][r] for k in tree} for r in range(w)]
    if isinstance(tree, int) and not isinstance(tree, bool):
        return [int(v) for v in gather_tensor(
            torch.tensor(tree, dtype=torch.int64,
                         device=collective_device(group)), group)]
    if dataclasses.is_dataclass(tree):
        cols = {f.name: gather_identities(getattr(tree, f.name), group)
                for f in dataclasses.fields(tree)}
        return [dataclasses.replace(tree, **{k: v[r]
                                             for k, v in cols.items()})
                for r in range(w)]
    return [tree] * w


def _own_params(net: nn.Module, shared: tuple) -> list:
    ids = {id(p) for p in shared}
    return [p for p in net.parameters() if id(p) not in ids]


class _IdpStep:
    """``step(state, gopt, batch, i, it, flags, other=None) -> (state,
    gopt, loss)``: this rank's identity's motion step on its frame ``i``;
    ``other`` is the mouth step's contrastive partner."""

    def __init__(self, motion, group, mouth: bool, shared: tuple = ()):
        self.motion, self.group, self.mouth = motion, group, mouth
        self.rank = world(group)[0]
        self.shared = shared

    @torch.no_grad()
    def refresh_others(self) -> None:
        """Every other identity's PMF parameters from its rank."""
        nets = self.motion.pmf_nets
        own = _own_params(nets[self.rank], self.shared)
        flat = torch.cat([p.reshape(-1) for p in own])
        every = all_gather(flat, self.group)
        for r, net in enumerate(nets):
            if r == self.rank:
                continue
            o = 0
            for p in _own_params(net, self.shared):
                p.copy_(every[r, o:o + p.numel()].view(p.shape))
                o += p.numel()

    def __call__(self, state, gopt, batch, i, it, flags, other=None):
        m = self.motion
        self.refresh_others()
        if self.mouth:
            loss, out, grads, g_off = m.loss_and_grads(
                state, self.rank, other, batch, i, flags)
        else:
            loss, out, grads, g_off = m.loss_and_grads(
                state, self.rank, batch, i, flags)
        umf = list(m.umf_net.parameters())
        for p, g in zip(umf, all_reduce_mean([p.grad for p in umf],
                                             self.group)):
            p.grad = g
        state, gopt = m._update(state, gopt, self.rank, out, grads, g_off,
                                it)
        return state, gopt, loss


def make_idp_pretrain_step(motion, group, share_audio_net: bool = False):
    """The identity-parallel face step over a serial face motion step
    ``motion`` (``train.pretrain.make_pretrain_face_step`` with one PMF
    an identity, all started alike on every rank): this rank trains
    ``motion.pmf_nets[rank]`` and its own cloud; the others' PMFs are
    refreshed from their ranks each step and never stepped here."""
    shared = (tuple(motion.umf_net.audio.parameters()) if share_audio_net
              else ())
    return _IdpStep(motion, group, mouth=False, shared=shared)


def make_idp_pretrain_mouth_step(motion, group):
    """The identity-parallel mouth step over a serial mouth motion step
    (``train.pretrain.make_pretrain_mouth_step``, whose ``face_states``
    hold this rank's face cloud at its rank)."""
    return _IdpStep(motion, group, mouth=True)


def make_idp_densify(opt_cfg, extent: float, num_ids: int, group):
    """``densify(state, gopt, gen, min_opacity, use_screen_size=False)``:
    draws every identity's [2, C, 3] split noise from ``gen`` (one
    generator every rank holds alike) and densifies this rank's identity
    with its row."""
    rank = world(group)[0]

    def densify(state, gopt, gen, min_opacity, use_screen_size=False):
        noise = torch.randn((num_ids, 2, state.capacity, 3), generator=gen,
                            device=state.alive.device)
        return G.densify_and_prune(
            state, gopt, noise[rank], opt_cfg.densify_grad_threshold,
            min_opacity, extent, 20.0 if use_screen_size else None,
            opt_cfg.percent_dense)

    return densify
