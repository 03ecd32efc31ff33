"""Bag-of-Words vocabulary: a hierarchical binary tree as level-wise
tensors.

Role of DBoW2's `TemplatedVocabulary` over ORB descriptors (vocabulary file
`mit_voc.yml` in the reference's launch files). Level l holds all
k^(l+1) candidate centroids as one (k^(l+1), 32) uint8 tensor; a
descriptor walks the tree with one Hamming argmin over its node's k
children per level — no pointer chasing. tf-idf weights as DBoW2 (TF_IDF
weighting, L1 norm).

Also here:
  * `build_vocabulary` — deterministic hierarchical binary k-means on the
    host (numpy), the same centroids from the same seed as the JAX
    package's;
  * `load_dbow2_yml` — the DBoW2 OpenCV-YAML vocabulary format, so
    `mit_voc.yml` (k = 10, L = 5 style) drops in unchanged.
"""

from __future__ import annotations

from collections import deque
import re
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..core.backend import resolve_device
from ..kernels.bow import sum_f32

_BIG = 2**30  # sorts after every word id


class Vocabulary(NamedTuple):
    k: int  # branching factor
    depth: int  # number of levels
    centroids: tuple  # per level: (k^(l+1), 32) uint8
    word_weights: torch.Tensor  # (k^depth,) float32 idf weights
    node_valid: tuple  # per level: (k^(l+1),) bool — the tree may be ragged

    @property
    def n_words(self) -> int:
        return self.k ** self.depth

    def to(self, device) -> "Vocabulary":
        return Vocabulary(
            k=self.k, depth=self.depth,
            centroids=tuple(c.to(device) for c in self.centroids),
            word_weights=self.word_weights.to(device),
            node_valid=tuple(v.to(device) for v in self.node_valid))


def _from_numpy(k, depth, centroids, word_weights, node_valid,
                device) -> Vocabulary:
    device = resolve_device(device)
    return Vocabulary(
        k=int(k), depth=int(depth),
        centroids=tuple(torch.from_numpy(np.array(c, np.uint8)).to(device)
                        for c in centroids),
        word_weights=torch.from_numpy(
            np.array(word_weights, np.float32)).to(device),
        node_valid=tuple(torch.from_numpy(np.array(v, bool)).to(device)
                         for v in node_valid))


def _hamming_rows(desc: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """desc (..., 32) uint8 vs cand (..., k, 32) uint8 -> (..., k) int32:
    XOR of the packed bytes, then a bytewise popcount (SWAR) summed."""
    x = torch.bitwise_xor(desc[..., None, :], cand)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return torch.sum(x, dim=-1, dtype=torch.int32)


def transform(vocab: Vocabulary, descriptors: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Word id of each descriptor: (..., K, 32) uint8 -> (..., K) int32,
    -1 where not `valid`. One Hamming argmin over the k children per level
    (the first of equal distances); invalid branches count as 257."""
    k = vocab.k
    dev = descriptors.device
    node = torch.zeros(descriptors.shape[:-1], dtype=torch.int64, device=dev)
    kids = torch.arange(k, device=dev)
    for lvl in range(vocab.depth):
        child0 = node * k
        idx = child0[..., None] + kids  # (..., K, k)
        d = _hamming_rows(descriptors, vocab.centroids[lvl][idx])
        d = torch.where(vocab.node_valid[lvl][idx], d, 257)
        node = child0 + torch.argmin(d, dim=-1)
    return torch.where(valid, node, -1).to(torch.int32)


def bow_from_words(word_ids: torch.Tensor, word_weights: torch.Tensor,
                   capacity: int):
    """Per-descriptor words (..., K) -> a padded sparse BoW vector per
    frame: unique word ids ascending (-1 padded) and tf-idf weights,
    L1-normalized (DBoW2 TF_IDF + L1 norm), plus the number of distinct
    words that did not fit in `capacity` (counted, not silently dropped).

    Returns (ids (..., capacity) int32, weights (..., capacity) float32,
    overflow (...) int32)."""
    K = word_ids.shape[-1]
    dev = word_ids.device
    ids = torch.where(word_ids >= 0, word_ids.to(torch.int64), _BIG)
    s = torch.sort(ids, dim=-1).values
    # unique segments of the sorted ids; padding is one trailing segment
    new_seg = torch.ones_like(s, dtype=torch.bool)
    new_seg[..., 1:] = s[..., 1:] != s[..., :-1]
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=-1) - 1
    counts = torch.zeros(s.shape, device=dev).scatter_add_(
        -1, seg_id, (s < _BIG).to(torch.float32))
    arange = torch.arange(K, device=dev)
    seg_start = torch.full(s.shape, K - 1, dtype=torch.int64,
                           device=dev).scatter_reduce_(
        -1, seg_id, arange.expand(s.shape), "amin", include_self=True)
    seg_word = torch.gather(s, -1, seg_start)
    idf = word_weights[torch.clamp(seg_word, 0, word_weights.shape[0] - 1)]
    w = counts * torch.where(seg_word < _BIG, idf, 0.0)
    last = seg_id[..., -1:]
    n_seg_valid = torch.sum((arange <= last) & (seg_word < _BIG), dim=-1)
    if capacity > K:  # pad the segment arrays up to the output capacity
        pad = (*s.shape[:-1], capacity - K)
        seg_word = torch.cat([seg_word, torch.full(
            pad, _BIG, dtype=torch.int64, device=dev)], -1)
        w = torch.cat([w, torch.zeros(pad, device=dev)], -1)
    in_range = torch.arange(capacity, device=dev) <= last
    sw = seg_word[..., :capacity]
    ids_out = torch.where(in_range & (sw < _BIG), sw, -1)
    w_out = torch.where(ids_out >= 0, w[..., :capacity], 0.0)
    norm = torch.clamp(sum_f32(w_out, keepdim=True), min=1e-12)
    overflow = torch.clamp(n_seg_valid - capacity, min=0)
    return (ids_out.to(torch.int32), w_out / norm,
            overflow.to(torch.int32))


def build_vocabulary(descriptors: np.ndarray, k: int = 8, depth: int = 3,
                     seed: int = 0, kmeans_iters: int = 8,
                     device="cuda") -> Vocabulary:
    """Deterministic hierarchical binary k-means, on the host (run once).

    Centroids are majority-bit aggregates (the binary-descriptor analogue
    of the mean); empty branches are marked invalid. idf weights from the
    training corpus (DBoW2: idf = log(N / n_word), words seen nowhere get
    weight 0). The numpy generator is called in the JAX package's order,
    so the same seed gives the same vocabulary. The tensors are placed on
    `device` (the card unless the caller asks for the CPU; raises if the
    card is asked for and there is none)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    bits = np.unpackbits(descriptors, axis=1, bitorder="little")  # (N, 256)
    n_nodes = [k ** (l + 1) for l in range(depth)]
    centroids = [np.zeros((n, 32), np.uint8) for n in n_nodes]
    node_valid = [np.zeros((n,), bool) for n in n_nodes]

    def kmeans(node_bits, kk):
        n = node_bits.shape[0]
        if n == 0:
            return (np.zeros((kk, 256), np.uint8), np.zeros((0,), np.int64),
                    np.zeros(kk, bool))
        init = node_bits[rng.choice(n, size=min(kk, n), replace=False)]
        cents = np.zeros((kk, 256), np.uint8)
        cents[: init.shape[0]] = init
        alive = np.zeros(kk, bool)
        alive[: init.shape[0]] = True
        assign = np.zeros(n, np.int64)
        for _ in range(kmeans_iters):
            d = (node_bits[:, None, :] != cents[None, :, :]).sum(-1)
            d[:, ~alive] = 10**6
            assign = d.argmin(1)
            for c in range(kk):
                m = assign == c
                if m.sum() > 0:
                    cents[c] = (node_bits[m].mean(0) > 0.5).astype(np.uint8)
                    alive[c] = True
                else:
                    alive[c] = False
        return cents, assign, alive

    frontier = {0: np.arange(bits.shape[0])}
    for lvl in range(depth):
        next_frontier = {}
        for parent, idxs in frontier.items():
            cents, assign, alive = kmeans(bits[idxs], k)
            base = parent * k
            centroids[lvl][base: base + k] = np.packbits(
                cents.astype(np.uint8), axis=1, bitorder="little")
            node_valid[lvl][base: base + k] = alive
            for c in range(k):
                child_idxs = idxs[assign == c] if len(idxs) else idxs
                if alive[c]:
                    next_frontier[base + c] = child_idxs
        frontier = next_frontier

    n_words = k ** depth
    word_weights = np.zeros(n_words, np.float32)
    leaf_counts = np.zeros(n_words, np.int64)
    for leaf, idxs in frontier.items():
        leaf_counts[leaf] = len(idxs)
    N = max(bits.shape[0], 1)
    nz = leaf_counts > 0
    word_weights[nz] = np.log(N / leaf_counts[nz])
    return _from_numpy(k, depth, centroids, word_weights, node_valid, device)


def load_dbow2_yml(path: str, device="cuda") -> Vocabulary:
    """Parse the DBoW2 OpenCV-YAML vocabulary format (`mit_voc.yml` style):

        vocabulary:
           k: 10
           L: 5
           scoringType: 0   (L1_NORM)
           weightingType: 0 (TF_IDF)
           nodes: [ { nodeId, parentId, weight, descriptor "32 dec bytes" } ]
           words: [ { wordId, nodeId } ]

    into the level-wise layout `transform` walks:

      * the tree is walked breadth-first over a parentId -> children map,
        so node ids may come in any order and children may carry smaller
        ids than their parents;
      * DBoW2 trees are ragged: a node that stops branching early is a word
        above the bottom level. Each such leaf is extended by a
        pass-through chain (one valid child holding the same centroid at
        every deeper level), so `transform` follows the chain to one leaf
        slot per word;
      * the word id is the flat leaf slot at level L-1. The file's `words:`
        block is cross-checked: every entry must name an existing leaf
        (a warning on stderr otherwise), and nodes the walk never reaches
        are counted and reported.

    The tensors are placed on `device`, the card unless the caller asks for
    the CPU.
    """
    device = resolve_device(device)
    with open(path) as f:
        txt = f.read()
    k = int(re.search(r"\bk:\s*(\d+)", txt).group(1))
    L = int(re.search(r"\bL:\s*(\d+)", txt).group(1))
    nodes_block = txt.split("nodes:")[1].split("words:")[0]
    field_re = re.compile(
        r"nodeId:\s*(\d+)\s*,?\s*parentId:\s*(-?\d+)\s*,?\s*"
        r"weight:\s*([\d.eE+-]+)\s*,?\s*descriptor:\s*\"?([0-9a-fA-F\s.]+?)"
        r"\"?\s*\}", re.S)
    nodes: dict[int, tuple[int, float, np.ndarray]] = {}
    children: dict[int, list[int]] = {}
    for m in field_re.finditer(nodes_block):
        nid_s, pid_s, w, desc = m.groups()
        desc = desc.strip()
        b = (bytes(int(float(x)) for x in desc.split()) if " " in desc
             else bytes.fromhex(desc))
        nid, pid = int(nid_s), int(pid_s)
        nodes[nid] = (pid, float(w), np.frombuffer(b, np.uint8))
        children.setdefault(pid, []).append(nid)

    words_block = txt.split("words:")[1] if "words:" in txt else ""
    word_re = re.compile(r"wordId:\s*(\d+)\s*,?\s*nodeId:\s*(\d+)")
    n_bad_words = sum(
        1 for mw in word_re.finditer(words_block)
        if int(mw.group(2)) not in nodes or int(mw.group(2)) in children)
    if n_bad_words:
        print(f"load_dbow2_yml: {n_bad_words} words-block entries "
              "reference missing or non-leaf nodes", file=sys.stderr)

    centroids = [np.zeros((k ** (l + 1), 32), np.uint8) for l in range(L)]
    node_valid = [np.zeros((k ** (l + 1),), bool) for l in range(L)]
    word_weights = np.zeros(k ** L, np.float32)

    # breadth-first from the virtual root (id 0, not in the nodes block)
    queue = deque([(0, -1, 0)])  # (nodeId, level, flat slot at that level)
    n_placed = n_dropped = 0
    while queue:
        pid, plvl, pslot = queue.popleft()
        lvl = plvl + 1
        kids = sorted(children.get(pid, ()))
        if lvl >= L:
            n_dropped += len(kids)
            continue
        for c, nid in enumerate(kids):
            if c >= k:  # malformed: more than k children
                n_dropped += 1
                continue
            idx = pslot * k + c
            _, w, desc = nodes[nid]
            d = np.zeros(32, np.uint8)
            d[: min(32, len(desc))] = desc[:32]
            centroids[lvl][idx] = d
            node_valid[lvl][idx] = True
            n_placed += 1
            if nid in children:  # internal node
                queue.append((nid, lvl, idx))
            else:  # a word, possibly above the bottom level
                leaf = idx
                for l2 in range(lvl + 1, L):  # pass-through chain
                    leaf = leaf * k
                    centroids[l2][leaf] = d
                    node_valid[l2][leaf] = True
                word_weights[leaf] = w
    n_orphan = len(nodes) - n_placed - n_dropped
    if n_dropped or n_orphan:
        print(f"load_dbow2_yml: dropped {n_dropped} malformed nodes, "
              f"{n_orphan} orphaned (placed {n_placed} of {len(nodes)})",
              file=sys.stderr)
    return _from_numpy(k, L, centroids, word_weights, node_valid, device)
