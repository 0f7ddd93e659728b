"""Static speculation trees ("growmaps").

JSON schema `{roots, branches, Successors, mask, depth, size}`, as in
`umbrella_tpu/speculation/tree.py`; all derived metadata (parents, per-level
gather indices, ancestor bitmap) is computed host-side in numpy.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class GrowMap:
    size: int
    roots: List[List[int]]  # node ids per level (contiguous ranges)
    branches: List[List[int]]  # per level, children counts per node
    successors: List[List[int]]
    bitmap: np.ndarray  # [size, size] bool — ancestor closure incl. self
    depth: np.ndarray  # [size] int32
    parents: np.ndarray  # [size] int32 (root's parent = 0)

    @property
    def num_levels(self) -> int:
        return len(self.roots)

    @property
    def node_in_path(self) -> np.ndarray:
        return self.bitmap.astype(np.int32).sum(-1)

    def level_start(self, level: int) -> int:
        return self.roots[level][0]

    def level_nodes(self, level: int) -> np.ndarray:
        return np.asarray(self.roots[level], dtype=np.int32)

    def level_gather_indices(self, level: int) -> np.ndarray:
        """Indices into flattened per-row top-k draft samples selecting, for parent j
        of this level, its first `branches[level][j]` children — in node order."""
        branch_list = self.branches[level]
        k = max(branch_list)
        out = []
        for j, b in enumerate(branch_list):
            out.extend(range(j * k, j * k + b))
        return np.asarray(out, dtype=np.int32)

    def level_topk(self, level: int) -> int:
        return max(self.branches[level])

    def total_branch(self, level: int) -> int:
        return sum(self.branches[level])

    @classmethod
    def from_dict(cls, d: dict) -> "GrowMap":
        size = int(d["size"])
        successors = d["Successors"]
        parents = np.zeros(size, dtype=np.int32)
        for v, succ in enumerate(successors):
            for child in succ:
                parents[child] = v
        return cls(
            size=size,
            roots=d["roots"],
            branches=d["branches"],
            successors=successors,
            bitmap=np.asarray(d["mask"]) == 1,
            depth=np.asarray(d["depth"], dtype=np.int32),
            parents=parents,
        )

    @classmethod
    def from_json(cls, path: str) -> "GrowMap":
        if not os.path.exists(path):
            # bundled trees: bare names or "umbrella/trees/x.json"-style paths
            # resolve to this package's trees/
            cand = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                "trees", os.path.basename(path))
            if os.path.exists(cand):
                path = cand
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return {
            "roots": self.roots,
            "branches": self.branches,
            "Successors": self.successors,
            "mask": self.bitmap.astype(int).tolist(),
            "depth": self.depth.tolist(),
            "size": self.size,
        }

    def validate(self) -> None:
        if self.depth[0] != 0:
            raise ValueError("tree root must have depth 0")
        for lvl, nodes in enumerate(self.roots):
            if nodes != list(range(nodes[0], nodes[0] + len(nodes))):
                raise ValueError("levels must be contiguous node-id ranges")
            for v in nodes:
                if self.depth[v] != lvl:
                    raise ValueError(f"node {v} has depth {self.depth[v]}, level {lvl}")
        for v in range(1, self.size):
            p = self.parents[v]
            if not (self.bitmap[v, p] and self.bitmap[v, v]):
                raise ValueError(f"node {v}: bitmap lacks its parent or itself")
