"""BVH disk cache.

The reference serialises both platform layouts into one chained-block
container file (magic 0x313F1A57; reference: loaders/load_bvh.cpp:45-302)
referenced by `accel` lines in .scene files or written via
`--write-accel`.  This renderer has a single traversal layout, so the
cache is one compressed npz per *scene* (world-space flattened BVH),
keyed by a fingerprint of the source assets and builder version so stale
caches are rejected — the role the reference's magic/type tags play.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..accel.flatten import ThreadedBvh
from ..utils.log import logger

CACHE_VERSION = 8  # bump when builder output layout changes


def fingerprint(paths: list[str], extra: str = "") -> str:
    h = hashlib.sha256()
    h.update(f"v{CACHE_VERSION}|{extra}".encode())
    for p in sorted(paths):
        try:
            st = os.stat(p)
            h.update(f"{p}|{st.st_size}|{st.st_mtime_ns}".encode())
        except OSError:
            h.update(f"{p}|missing".encode())
    return h.hexdigest()[:24]


def cache_path_for(scene_path: str) -> str:
    return os.path.splitext(scene_path)[0] + ".bvh.npz"


def store_accel(path: str, bvh: ThreadedBvh, key: str) -> None:
    np.savez_compressed(
        path,
        key=np.frombuffer(key.encode(), np.uint8),
        nodes64=bvh.nodes64,
        nodes64o=bvh.nodes64o if bvh.nodes64o is not None else np.zeros((0, 64), np.float32),
        nodes16=bvh.nodes16,
        leaf48=bvh.leaf48,
        node_min=bvh.node_min,
        node_max=bvh.node_max,
        hit_link=bvh.hit_link,
        miss_link=bvh.miss_link,
        leaf_start=bvh.leaf_start,
        tri_v0=bvh.tri_v0,
        tri_e1=bvh.tri_e1,
        tri_e2=bvh.tri_e2,
        tri_id=bvh.tri_id,
        stats_nodes=np.int64(bvh.stats.get("nodes", 0)),
        stats_leaves=np.int64(bvh.stats.get("leaves", 0)),
        stats_depth=np.int64(bvh.stats.get("max_depth", 0)),
    )
    logger.info("wrote BVH cache %s", path)


def load_accel(path: str, key: str) -> ThreadedBvh | None:
    """Load a cached BVH; returns None on mismatch/corruption (caller
    rebuilds, as the reference does on magic mismatch, load_bvh.cpp:54-60)."""
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path)
        stored = bytes(z["key"]).decode()
        if stored != key:
            logger.info("BVH cache stale (%s)", path)
            return None
        n64o = z["nodes64o"]
        return ThreadedBvh(
            nodes64=z["nodes64"],
            nodes64o=n64o if n64o.size else None,
            nodes16=z["nodes16"],
            leaf48=z["leaf48"],
            node_min=z["node_min"],
            node_max=z["node_max"],
            hit_link=z["hit_link"],
            miss_link=z["miss_link"],
            leaf_start=z["leaf_start"],
            tri_v0=z["tri_v0"],
            tri_e1=z["tri_e1"],
            tri_e2=z["tri_e2"],
            tri_id=z["tri_id"],
            stats={
                "nodes": int(z["stats_nodes"]),
                "leaves": int(z["stats_leaves"]),
                "max_depth": int(z["stats_depth"]),
            },
        )
    except Exception as e:  # corrupt cache -> rebuild
        logger.warning("BVH cache unreadable (%s): %s", path, e)
        return None
