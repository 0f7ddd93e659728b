"""Offline Sequoia tree construction (host-side numpy).

Counterpart of `umbrella_tpu/sequoia.py`: level by level, expand every frontier
node with `num_beams` candidate children scored `log(acc[k]) + parent_score`,
keep the global top-`width`, and emit the growmap JSON schema.
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from .speculation.tree import GrowMap

DEFAULT_ACC = [0.65, 0.2, 0.1, 0.05]


def successor_list_to_mask(successors: List[List[int]]) -> List[List[int]]:
    """n x n ancestor-closure mask: mask[i][j] = 1 iff j is an ancestor of i (or i)."""
    n = len(successors)
    parent = [None] * n
    for v, succ in enumerate(successors):
        for c in succ:
            parent[c] = v
    mask = [[0] * n for _ in range(n)]
    for i in range(n):
        v = i
        while v is not None:
            mask[i][v] = 1
            v = parent[v]
    return mask


def generate_sequoia_tree(
    width: int,
    depth: int,
    acc: Optional[List[float]] = None,
    json_file: Optional[str] = None,
) -> dict:
    """Build a width x depth Sequoia growmap from a positional acceptance vector."""
    if acc is None:
        if width > len(DEFAULT_ACC):
            raise ValueError("default acceptance vector requires width<=4")
        acc = DEFAULT_ACC
    log_acc = np.log(np.asarray(acc, dtype=np.float64))
    num_beams = len(log_acc)

    roots: List[List[int]] = [[0]]
    branches: List[List[int]] = [[0]]
    successors: List[List[int]] = [[]]
    depths: List[int] = [0]
    frontier_scores = np.zeros(1)
    total = 1

    for lvl in range(depth):
        frontier = roots[lvl]
        cand_scores = frontier_scores[:, None] + log_acc[None, :]
        flat = cand_scores.reshape(-1)
        k = min(width, flat.size)
        top = np.argsort(-flat, kind="stable")[:k]
        parents_local = top // num_beams  # index into frontier

        new_ids = list(range(total, total + k))
        total += k
        roots.append(new_ids)
        branches.append([0] * k)  # leaf level stays 0; overwritten next iteration
        depths.extend([lvl + 1] * k)
        successors.extend([[] for _ in range(k)])

        # children grouped by parent: the engine's per-level gather relies on it
        order = np.argsort(parents_local, kind="stable")
        lvl_branch = [0] * len(frontier)
        new_scores = np.empty(k)
        for slot, oi in enumerate(order):
            p_local = int(parents_local[oi])
            child = new_ids[slot]
            successors[frontier[p_local]].append(child)
            lvl_branch[p_local] += 1
            new_scores[slot] = flat[top[oi]]
        branches[lvl] = lvl_branch
        frontier_scores = new_scores

    result = {
        "roots": roots,
        "branches": branches,
        "Successors": successors,
        "mask": successor_list_to_mask(successors),
        "depth": depths,
        "size": total,
    }
    if json_file:
        with open(json_file, "w") as f:
            json.dump(result, f, indent=4)
    return result


def growmap_from_spec(width: int, depth: int, acc: Optional[List[float]] = None) -> GrowMap:
    gm = GrowMap.from_dict(generate_sequoia_tree(width, depth, acc))
    gm.validate()
    return gm
