"""MCTS over noise trajectories (counterpart of
diffusion_tts_tpu/search/mcts.py).

Per timestep (the EDM reference's MCTS, edm/main.py:405-713): (1) expand
the root with b = params.N children if it has none; (2) run S rollouts:
UCB1 descent (exploit r/v + explore sqrt(2 ln v_parent / v_child),
unvisited = +inf) down the persisted tree, expansion of the reached leaf
with b children from a per-depth noise table (edm/main.py:437-447), a
random child pick, then a zero-noise rollout to the end whose terminal
score is backpropagated along the path; (3) move the root to the child
with the best average reward. The tree persists across timesteps.

The tree is the JAX package's fixed-capacity arena with a leading sample
axis (``_Tree``), in fp32 whatever the model's dtype, on the latents'
device. The schedule is the JAX package's too, so the same forwards run
(``search/nfe.py`` counts them) and the same choices are made:

- ``rollout_batch`` rollouts share one phase: selection sees the tree grow,
  but visits and rewards are updated only at the phase's end (default S,
  one phase, the reference's batched simulations; 1 is sequential MCTS);
- a phase runs rollout_batch + 1 iterations, and iteration q expands the
  leaf selected at q - 1 (q = 0: the root, or a fill that every lane masks
  off, whose forwards still run); a write to the arena is masked per
  sample, and the shared slot count moves only when some sample expands;
- the phase's rollouts run as one batch, rollout-major ([r*B], sample
  fastest), over every step with the lanes that start later masked.

The two draws a caller cannot inject (the random child pick and the
``fresh_expansion`` noise) are each made by one module-level function
below.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diffusion_tts_torch.search.noise import (
    SALT_MCTS_EXPAND,
    SALT_MCTS_PICK,
    SALT_MCTS_TAB,
    InjectedNoise,
)
from diffusion_tts_torch.utils import rng
from diffusion_tts_torch.utils.config import SearchParams

_NEG_INF = -1e30
_POS_INF = 1e30


class MCTSResult(NamedTuple):
    x: torch.Tensor  # terminal latents [B, ...]


class _Tree(NamedTuple):
    states: torch.Tensor  # [B, MAXN, *feat] fp32
    parent: torch.Tensor  # [B, MAXN] long, -1 = none
    depth: torch.Tensor  # [B, MAXN] long
    children: torch.Tensor  # [B, MAXN, b] long, -1 = empty
    n_children: torch.Tensor  # [B, MAXN] long
    reward: torch.Tensor  # [B, MAXN] fp32
    visits: torch.Tensor  # [B, MAXN] long
    count: int  # slots in use, shared by the samples
    root: torch.Tensor  # [B] long


def pick_draw(key: int, i: int, phase: int, q: int, bsz: int, b_exp: int,
              device) -> torch.Tensor:
    """The random child of the leaf expanded at iteration q, one per
    sample: [B] in [0, b_exp)."""
    g = rng.generator(key, SALT_MCTS_PICK, i, phase, q - 1, device=device)
    return torch.randint(0, b_exp, (bsz,), generator=g, device=device)


def fresh_expansion_draw(key: int, i: int, phase: int, q: int, shape, device) -> torch.Tensor:
    """fresh_expansion's noise for iteration q's expansion: [B, b, *feat]."""
    return rng.normal(key, (SALT_MCTS_EXPAND, i, phase, q), shape, device)


def _mcts_dims(params: SearchParams, rollout_batch: int | None) -> tuple[int, int, int]:
    b_exp, s_rollouts = params.N, params.S  # branching factor, rollouts per timestep
    rollout_batch = min(s_rollouts if rollout_batch is None else rollout_batch, s_rollouts)
    return b_exp, rollout_batch, -(-s_rollouts // rollout_batch)


def mcts_init(backend, z: torch.Tensor, key: int, params: SearchParams, *,
              rollout_batch: int | None = None,
              noise: InjectedNoise | None = None) -> tuple[_Tree, torch.Tensor]:
    """The arena and the per-depth noise table [steps, B, b, *feat]. The
    arena holds every slot a search can take: per timestep one root and
    n_phases * rollout_batch leaf expansions of b children each."""
    b_exp, rollout_batch, n_phases = _mcts_dims(params, rollout_batch)
    bsz, feat, dev = z.shape[0], z.shape[1:], z.device
    steps = backend.num_steps
    maxn = 1 + steps * (1 + n_phases * rollout_batch) * b_exp
    if noise is not None and noise.mcts_table is not None:
        noise_tab = noise.mcts_table.to(dev, torch.float32)
    else:
        noise_tab = rng.normal(key, (SALT_MCTS_TAB,), (steps, bsz, b_exp) + feat, dev)
    states = torch.zeros((bsz, maxn) + feat, dtype=torch.float32, device=dev)
    states[:, 0] = backend.init_latents(z)
    visits = torch.zeros((bsz, maxn), dtype=torch.long, device=dev)
    visits[:, 0] = 1
    tree = _Tree(
        states=states,
        parent=torch.full((bsz, maxn), -1, dtype=torch.long, device=dev),
        depth=torch.zeros((bsz, maxn), dtype=torch.long, device=dev),
        children=torch.full((bsz, maxn, b_exp), -1, dtype=torch.long, device=dev),
        n_children=torch.zeros((bsz, maxn), dtype=torch.long, device=dev),
        reward=torch.zeros((bsz, maxn), dtype=torch.float32, device=dev),
        visits=visits, count=1, root=torch.zeros((bsz,), dtype=torch.long, device=dev))
    return tree, noise_tab


def mcts_result(tree: _Tree) -> MCTSResult:
    rows = torch.arange(tree.root.shape[0], device=tree.root.device)
    return MCTSResult(x=tree.states[rows, tree.root])


def _expand_nodes(backend, tree: _Tree, noise_tab: torch.Tensor, nodes: torch.Tensor,
                  do_expand: torch.Tensor, eps: torch.Tensor | None) -> _Tree:
    """Add b children to nodes [B] where do_expand [B], in place. The
    sampler step runs for every lane, masked ones included; the arena's
    writes are masked, and count moves by b only if some sample expands."""
    bsz, b_exp = nodes.shape[0], noise_tab.shape[2]
    feat = tree.states.shape[2:]
    rows = torch.arange(bsz, device=nodes.device)
    d = tree.depth[rows, nodes]
    d_clip = d.clamp(0, backend.num_steps - 1)
    if eps is None:
        eps = noise_tab[d_clip, rows]  # [B, b, *feat]
    # candidate-major ([child, sample] -> child*B + sample), as backend.expand
    x_flat = tree.states[rows, nodes].unsqueeze(0).expand((b_exp, bsz) + feat)
    x_flat = x_flat.reshape((b_exp * bsz,) + feat)
    eps_flat = eps.transpose(0, 1).reshape((b_exp * bsz,) + feat)
    d_flat = d_clip.repeat(b_exp)
    child = backend.advance(x_flat, d_flat, backend.base_step(x_flat, d_flat), eps_flat)
    child = child.reshape((b_exp, bsz) + feat).transpose(0, 1).float()  # [B, b, *feat]
    if not bool(do_expand.any()):
        return tree

    slots = slice(tree.count, tree.count + b_exp)
    m = do_expand[:, None]
    tree.states[:, slots] = torch.where(do_expand.reshape((bsz,) + (1,) * (len(feat) + 1)),
                                        child, tree.states[:, slots])
    for arr, value in ((tree.parent, nodes[:, None]), (tree.depth, (d + 1)[:, None]),
                       (tree.reward, 0.0), (tree.visits, 0)):
        arr[:, slots] = torch.where(m, value, arr[:, slots])
    ids = torch.arange(tree.count, tree.count + b_exp, device=nodes.device)
    tree.children[rows, nodes] = torch.where(m, ids, tree.children[rows, nodes])
    tree.n_children[rows, nodes] = torch.where(do_expand, b_exp, tree.n_children[rows, nodes])
    return tree._replace(count=tree.count + b_exp)


def _select_path(tree: _Tree, num_steps: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """UCB descent from the root: (leaf [B], path [B, steps + 2] with
    path[:, 0] = root and -1 past its end, path length [B])."""
    bsz = tree.root.shape[0]
    rows = torch.arange(bsz, device=tree.root.device)
    path = torch.full((bsz, num_steps + 2), -1, dtype=torch.long, device=rows.device)
    path[:, 0] = tree.root
    node, plen = tree.root, torch.ones_like(tree.root)
    active = tree.n_children[rows, node] > 0
    for t in range(num_steps + 1):
        ch = tree.children[rows, node]  # [B, b]
        ch_safe = ch.clamp(min=0)
        v_c = tree.visits[rows[:, None], ch_safe].float()
        r_c = tree.reward[rows[:, None], ch_safe]
        v_p = tree.visits[rows, node].float().clamp(min=1.0)
        explore = torch.sqrt(2.0 * torch.log(v_p)[:, None] / v_c.clamp(min=1.0))
        ucb = torch.where(v_c == 0, _POS_INF, r_c / v_c.clamp(min=1.0) + explore)
        ucb = torch.where(ch >= 0, ucb, _NEG_INF)
        nxt = ch_safe[rows, torch.argmax(ucb, dim=1)]  # the first maximum
        node = torch.where(active, nxt, node)
        path[:, t + 1] = torch.where(active, node, path[:, t + 1])
        plen = plen + active.long()
        active = active & (tree.n_children[rows, node] > 0)
    return node, path, plen


def mcts_timestep(backend, tree: _Tree, noise_tab: torch.Tensor, key: int, i: int,
                  params: SearchParams, *, rollout_batch: int | None = None,
                  fresh_expansion: bool = False) -> _Tree:
    """One timestep: the phases' expansions and rollouts with deferred
    backprop, then the root's advance. Updates the arena in place.

    fresh_expansion=True draws new expansion noise per (timestep, phase,
    iteration) instead of the per-depth table, with which every expansion
    of a node at depth d proposes the same b children."""
    b_exp, rollout_batch, n_phases = _mcts_dims(params, rollout_batch)
    bsz, feat = tree.root.shape[0], tree.states.shape[2:]
    steps = backend.num_steps
    dev = tree.root.device
    rows = torch.arange(bsz, device=dev)
    for phase in range(n_phases):
        leaf = tree.root
        pending = (tree.n_children[rows, tree.root] == 0) & (phase == 0)
        path, plen = None, None
        sims_x, sims_d, paths = [], [], []
        for q in range(rollout_batch + 1):
            first_child = tree.count
            eps = (fresh_expansion_draw(key, i, phase, q, (bsz, b_exp) + feat, dev)
                   if fresh_expansion else None)
            tree = _expand_nodes(backend, tree, noise_tab, leaf, pending, eps)
            if q > 0:  # complete rollout q - 1 at a random child of its leaf
                pick = pick_draw(key, i, phase, q, bsz, b_exp, dev)
                node = torch.where(pending, first_child + pick, leaf)
                last = path.shape[1] - 1
                path[rows, torch.where(pending, plen, last)] = torch.where(
                    pending, node, path[:, last])
                plen = plen + pending.long()
                sims_x.append(tree.states[rows, node])
                sims_d.append(tree.depth[rows, node])
                paths.append(path)
            if q < rollout_batch:  # select the leaf the next iteration expands
                leaf, path, plen = _select_path(tree, steps)
                pending = tree.depth[rows, leaf] < steps - 1

        # the phase's simulations as one batch, then the deferred backprop
        sim_x = torch.stack(sims_x).reshape((rollout_batch * bsz,) + feat)
        images = backend.rollout(sim_x, torch.stack(sims_d).reshape(-1))
        rewards = backend.score(images).float().reshape(rollout_batch, bsz)
        for path, rew in zip(paths, rewards):
            ok = path >= 0
            idx = path.clamp(min=0)
            tree.reward.scatter_add_(1, idx, torch.where(ok, rew[:, None], 0.0))
            tree.visits.scatter_add_(1, idx, ok.long())

    # advance the root to the child with the best average (edm/main.py:684-703)
    ch = tree.children[rows, tree.root]
    ch_safe = ch.clamp(min=0)
    v = tree.visits[rows[:, None], ch_safe].float()
    avg = torch.where((ch >= 0) & (v > 0), tree.reward[rows[:, None], ch_safe] / v.clamp(min=1.0),
                      _NEG_INF)
    return tree._replace(root=ch_safe[rows, torch.argmax(avg, dim=1)])


def mcts_search(backend, z: torch.Tensor, key: int, params: SearchParams, *,
                rollout_batch: int | None = None, noise: InjectedNoise | None = None,
                fresh_expansion: bool = False) -> MCTSResult:
    tree, noise_tab = mcts_init(backend, z, key, params, rollout_batch=rollout_batch,
                                noise=noise)
    for i in range(backend.num_steps):
        tree = mcts_timestep(backend, tree, noise_tab, key, i, params,
                             rollout_batch=rollout_batch, fresh_expansion=fresh_expansion)
    return mcts_result(tree)


__all__ = ["mcts_search", "mcts_init", "mcts_timestep", "mcts_result", "MCTSResult",
           "pick_draw", "fresh_expansion_draw"]
