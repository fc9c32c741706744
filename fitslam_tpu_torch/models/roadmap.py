"""Keyframe-anchored exploration roadmap (port of
``fitslam_tpu/models/roadmap.py``; FrontierRoadMap + its A*):

- a fixed-capacity node table over explored space with min-separation dedup,
- edges to the nearest nodes within range whose straight line hits no
  obstacle and is mostly known (isConnectable),
- nodes anchored to the nearest SLAM keyframe so the roadmap deforms with
  the optimized pose graph,
- shortest paths by Bellman-Ford label correction (distances from a source
  to ALL nodes at once) and line-of-sight path refinement.

Everything stays on the device; ``extract_path`` is host code over a parent
row the caller has already read back.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.ops import lie, raycast
from fitslam_tpu_torch.ops.grid import GridSpec2D

INF = 1e9


class Roadmap(NamedTuple):
    xy: torch.Tensor          # (N, 2) world positions
    kf_parent: torch.Tensor   # (N,) int32 anchor keyframe
    p_kf: torch.Tensor        # (N, 3) position in anchor-KF camera frame
    valid: torch.Tensor       # (N,) bool
    is_frontier: torch.Tensor # (N,) bool (frontier node vs pose node)
    n_nodes: torch.Tensor     # () int32
    adj: torch.Tensor         # (N, E) int32 neighbor index (-1 = none)
    adj_dist: torch.Tensor    # (N, E) float32 edge length (INF = none)

    @property
    def capacity(self) -> Tuple[int, int]:
        return self.xy.shape[0], self.adj.shape[1]


def empty_roadmap(max_nodes: int, max_edges_per_node: int = 16, device="cuda") -> Roadmap:
    N, E = max_nodes, max_edges_per_node
    return Roadmap(
        xy=torch.zeros((N, 2), dtype=torch.float32, device=device),
        kf_parent=torch.zeros((N,), dtype=torch.int32, device=device),
        p_kf=torch.zeros((N, 3), dtype=torch.float32, device=device),
        valid=torch.zeros((N,), dtype=torch.bool, device=device),
        is_frontier=torch.zeros((N,), dtype=torch.bool, device=device),
        n_nodes=torch.zeros((), dtype=torch.int32, device=device),
        adj=torch.full((N, E), -1, dtype=torch.int32, device=device),
        adj_dist=torch.full((N, E), INF, dtype=torch.float32, device=device),
    )


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of a - b (broadcast), as
    ``jnp.linalg.norm``: sqrt of the summed squares."""
    d = a - b
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def _set_rows(buf: torch.Tensor, slot: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``buf.at[slot].set(values, mode="drop")`` with slot == N dropped."""
    ext = torch.cat([buf, buf[:1]])
    ext[slot] = values.to(buf.dtype)
    return ext[:-1]


def add_nodes(
    rm: Roadmap,
    cand_xy: torch.Tensor,        # (M, 2) candidate node positions (world)
    cand_valid: torch.Tensor,     # (M,) bool
    cand_is_frontier: torch.Tensor,  # (M,) bool
    kf_T_cw: lie.SE3,             # (K,) keyframe poses (for anchoring)
    n_kf,                         # () int32 (tensor or int)
    min_separation: float = 0.45,
) -> Roadmap:
    """Insert candidates not within min_separation of an existing node (or an
    earlier candidate). Anchors each accepted node to the nearest keyframe."""
    N, _ = rm.capacity
    M = cand_xy.shape[0]
    dev = cand_xy.device

    # dedup vs existing nodes
    d_exist = _dist(cand_xy[:, None, :], rm.xy[None, :, :])
    d_exist = torch.where(rm.valid[None, :], d_exist, INF)
    clash_exist = d_exist.min(dim=1).values < min_separation

    # dedup within the batch (earlier candidate wins)
    d_batch = _dist(cand_xy[:, None, :], cand_xy[None, :, :])
    ar = torch.arange(M, device=dev)
    earlier = ar[None, :] < ar[:, None]
    clash_batch = ((d_batch < min_separation) & earlier & cand_valid[None, :]).any(dim=1)

    accept = cand_valid & ~clash_exist & ~clash_batch
    slot = rm.n_nodes + torch.cumsum(accept.to(torch.int32), 0, dtype=torch.int32) - 1
    accept = accept & (slot < N)
    slot_w = torch.where(accept, slot, N).long()

    # anchor to nearest keyframe (by camera position)
    kf_xy = lie.inverse(kf_T_cw).t[:, :2]                     # (K, 2)
    kf_ok = torch.arange(kf_xy.shape[0], device=dev) < n_kf
    d_kf = _dist(cand_xy[:, None, :], kf_xy[None, :, :])
    d_kf = torch.where(kf_ok[None, :], d_kf, INF)
    parent = torch.argmin(d_kf, dim=1)                        # (M,)
    R_p, t_p = kf_T_cw.R[parent], kf_T_cw.t[parent]
    p_world = torch.cat([cand_xy, torch.zeros((M, 1), dtype=cand_xy.dtype, device=dev)], dim=-1)
    p_kf = (R_p @ p_world[..., None])[..., 0] + t_p

    return rm._replace(
        xy=_set_rows(rm.xy, slot_w, cand_xy),
        kf_parent=_set_rows(rm.kf_parent, slot_w, parent),
        p_kf=_set_rows(rm.p_kf, slot_w, p_kf),
        valid=_set_rows(rm.valid, slot_w, torch.ones_like(cand_valid)),
        is_frontier=_set_rows(rm.is_frontier, slot_w, cand_is_frontier),
        n_nodes=torch.clamp(rm.n_nodes + accept.sum(dtype=torch.int32), max=N),
    )


def reanchor_nodes(rm: Roadmap, kf_T_cw: lie.SE3) -> Roadmap:
    """optimizeSHM equivalent: recompute world positions from (corrected)
    anchor keyframe poses — the roadmap deforms with the SLAM graph."""
    parent = rm.kf_parent.long()
    T_wc = lie.inverse(lie.SE3(kf_T_cw.R[parent], kf_T_cw.t[parent]))
    p_w = (T_wc.R @ rm.p_kf[..., :, None])[..., 0] + T_wc.t
    return rm._replace(xy=torch.where(rm.valid[:, None], p_w[:, :2], rm.xy))


def connect_edges(
    rm: Roadmap,
    spec: GridSpec2D,
    occ: torch.Tensor,
    max_edge_length: float = 6.1,
    max_unknown_fraction: float = 0.3,
) -> Roadmap:
    """Rebuild the (N, E) adjacency: top-E nearest candidates within range
    whose connecting segment is obstacle-free and mostly known (the
    reConstructGraph + isConnectable pipeline as three batched stages)."""
    N, E = rm.capacity
    d = _dist(rm.xy[:, None, :], rm.xy[None, :, :])
    ar = torch.arange(N, device=d.device)
    ok = (rm.valid[:, None] & rm.valid[None, :] & (d <= max_edge_length)
          & (ar[:, None] != ar[None, :]))
    d_masked = torch.where(ok, d, INF)
    # top-E nearest candidates per node; lax.top_k breaks ties (most of the
    # row sits at INF) by the lower index, which a stable sort keeps
    cand = torch.sort(-d_masked, dim=1, descending=True, stable=True).indices[:, :E]
    cand_d = torch.gather(d_masked, 1, cand)
    cand_ok = cand_d < INF

    # batched raycast on all N*E candidate segments
    a = rm.xy.repeat_interleave(E, dim=0)
    b = rm.xy[cand.reshape(-1)]
    hit, unk = raycast.segment_clearance(spec, occ, a, b)
    hit = hit.reshape(N, E)
    unk = unk.reshape(N, E)
    good = cand_ok & ~hit & (unk < max_unknown_fraction)

    return rm._replace(
        adj=torch.where(good, cand, -1).to(torch.int32),
        adj_dist=torch.where(good, cand_d, INF),
    )


def shortest_paths_multi(
    rm: Roadmap,
    sources_xy: torch.Tensor,    # (S, 2) world positions
    iters: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bellman-Ford label correction from the node nearest each source:
    ((S, N) dist, (S, N) parent, (S,) source node). The S rows relax
    together, one batch of gathers per iteration."""
    N, E = rm.capacity
    S = sources_xy.shape[0]
    dev = sources_xy.device
    d_src = _dist(rm.xy[None, :, :], sources_xy[:, None, :])
    d_src = torch.where(rm.valid[None, :], d_src, INF)
    src = torch.argmin(d_src, dim=1)                          # (S,)

    dist = torch.full((S, N), INF, dtype=torch.float32, device=dev)
    dist.scatter_(1, src[:, None], 0.0)
    parent = torch.full((S, N), -1, dtype=torch.int64, device=dev)
    parent.scatter_(1, src[:, None], src[:, None])

    adj_safe = torch.clamp_min(rm.adj, 0).long()               # (N, E)
    adj_rows = adj_safe.expand(S, N, E)
    has_edge = rm.adj >= 0
    for _ in range(iters):
        nb_dist = dist[:, adj_safe] + rm.adj_dist              # (S, N, E)
        nb_dist = torch.where(has_edge, nb_dist, INF)
        best = nb_dist.amin(dim=2)
        best_e = nb_dist.argmin(dim=2)                         # first on ties
        better = best < dist
        dist = torch.where(better, best, dist)
        parent = torch.where(better, torch.gather(adj_rows, 2, best_e[..., None])[..., 0],
                             parent)
    dist = torch.where(rm.valid[None, :], dist, INF)
    return dist, parent.to(torch.int32), src.to(torch.int32)


def shortest_paths(
    rm: Roadmap,
    source_xy: torch.Tensor,     # (2,) world position (snapped to nearest node)
    iters: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bellman-Ford from the node nearest source_xy: (dist (N,) meters,
    parent (N,) int32, source node index). One run prices paths to every
    frontier/node."""
    dist, parent, src = shortest_paths_multi(rm, source_xy[None, :], iters)
    return dist[0], parent[0], src[0]


def nearest_node(rm: Roadmap, xy: torch.Tensor) -> torch.Tensor:
    d = _dist(rm.xy, xy[None, :])
    return torch.argmin(torch.where(rm.valid, d, INF)).to(torch.int32)


def extract_path(rm: Roadmap, parent, src: int, goal_node: int, max_len: int = 64):
    """Host-side: walk parents from goal back to src. Returns list of node
    indices (src..goal) or [] if unreachable."""
    parent = np.asarray(parent)
    path = [int(goal_node)]
    for _ in range(max_len):
        p = int(parent[path[-1]])
        if p < 0:
            return []
        if p == path[-1] or p == int(src):
            path.append(int(src))
            break
        path.append(p)
    return list(reversed(path))


def refine_path_los(
    spec: GridSpec2D,
    occ: torch.Tensor,
    waypoints: torch.Tensor,      # (W, 2) padded path
    w_valid: torch.Tensor,        # (W,) bool
) -> torch.Tensor:
    """Line-of-sight shortcut mask (reference refinePath): waypoint i is
    droppable if the segment (i-1, i+1) is clear. One batched raycast."""
    prev_xy = torch.roll(waypoints, 1, dims=0)
    next_xy = torch.roll(waypoints, -1, dims=0)
    hit, unk = raycast.segment_clearance(spec, occ, prev_xy, next_xy)
    ar = torch.arange(waypoints.shape[0], device=waypoints.device)
    interior = (w_valid & torch.roll(w_valid, 1) & torch.roll(w_valid, -1)
                & (ar > 0) & (ar < waypoints.shape[0] - 1))
    droppable = interior & ~hit & (unk < 0.3)
    return w_valid & ~droppable
