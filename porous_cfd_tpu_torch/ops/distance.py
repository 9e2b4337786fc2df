"""Minimum-distance fields (the SDF feature, interface distances), with an
optional split of the query points over a mesh's 'points' axis (the port's
counterpart of ``porous_cfd_tpu/ops/distance.py``).

Plain torch, on the device of the tensors given (numpy arrays stay on the
host), in query chunks so that no more than (chunk, M) distances exist at
once. The differences are taken in float64: the JAX package's float32
``|q|^2 - 2 q.t + |t|^2`` form loses digits to cancellation near the
boundary, where the SDF is small. The JAX module is plain XLA, no kernel.
"""
from __future__ import annotations

import numpy as np
import torch


def min_distance(query, target, chunk: int = 2048):
    """Min distance from each query point (N, D) to the target cloud (M, D),
    in float64: a numpy array for numpy inputs, else a tensor on the
    query's device."""
    host = not torch.is_tensor(query)
    q = torch.as_tensor(query, dtype=torch.float64)
    t = torch.as_tensor(target, dtype=torch.float64, device=q.device)
    out = torch.cat([torch.cdist(q_blk, t, compute_mode="donot_use_mm_for_euclid_dist")
                     .min(dim=-1).values for q_blk in torch.split(q, max(1, chunk))])
    return out.numpy() if host else out


def min_distance_sharded(query, target, mesh, chunk: int = 2048):
    """``min_distance`` with the query rows split over the mesh's 'points'
    axis: padded to a multiple of its size, as the JAX version pads, each
    rank takes its contiguous slice and the minima are gathered over the
    points group. Every rank of the group passes the same clouds and gets
    all N minima (a tensor on its mesh device, or a numpy array for numpy
    inputs)."""
    host = not torch.is_tensor(query)
    q = torch.as_tensor(query, dtype=torch.float64).to(mesh.device)
    n_shards = mesh.shape["points"]
    n = q.shape[0]
    q = torch.cat([q, q.new_zeros(((-n) % n_shards, q.shape[1]))])
    per = q.shape[0] // n_shards
    k = mesh.index("points")
    mine = min_distance(q[k * per:(k + 1) * per], torch.as_tensor(target).to(q.device), chunk)
    out = torch.cat(mesh.all_gather(mine, "points"))[:n]
    return out.cpu().numpy() if host else out


def sdf_feature(internal_points: np.ndarray, boundary_points: np.ndarray,
                zone: np.ndarray, mesh=None) -> np.ndarray:
    """The dataset SDF feature (foam_dataset.py:360-381 semantics): min
    distance of every point to the boundary cloud, max-normalized; internal
    porous side negative, boundary rows positive. On the host, or split over
    the 'points' axis of ``mesh`` where it has more than one rank."""
    all_points = np.concatenate([internal_points, boundary_points])
    if mesh is not None and mesh.shape["points"] > 1:
        d = min_distance_sharded(all_points, boundary_points, mesh)
    else:
        d = min_distance(all_points, boundary_points)
    d = d / d.max()
    n_int = len(internal_points)
    sign = np.ones(len(all_points))
    sign[:n_int] = (0.5 - np.asarray(zone).flatten()) * 2
    return d * sign
