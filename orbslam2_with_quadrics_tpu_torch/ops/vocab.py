"""Binary bag-of-words vocabulary: hierarchical k-medians, transform, score
(torch).

Counterpart of the reference's ``ops/vocab.py``: the vocabulary is a
per-level array of binary centers; the image -> BoW transform is a batched
tree descent where each level is one Hamming argmin over gathered child
centers; BoW vectors are dense tf-idf arrays (small vocabularies) or
sorted-unique (word, value) lists (large ones), scored by one vectorized L1
sweep.

Descriptors and centers are [.., 8] int32 views of the 256-bit uint32 words.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .matching import _BIG, _ratio_ok, _resolve_one_to_one, best_two, hamming_matrix, popcount_words

_INT32_MAX = 2147483647


class Vocabulary(NamedTuple):
    centers: Sequence[torch.Tensor]  # per level l: [k^(l+1), 8] int32
    idf: torch.Tensor                # [V] inverse document frequency
    k: int
    levels: int

    @property
    def n_words(self) -> int:
        return self.k ** self.levels


class TreeVocabulary(NamedTuple):
    """Explicit-tree vocabulary loaded from the DBoW2 text format.

    Unlike the implicit complete k-ary tree of :class:`Vocabulary`,
    DBoW2-trained trees can be ragged (nodes with < k children, leaves
    above the bottom level). Early leaves are extended to the bottom with
    single-child virtual chains so the descent stays a fixed ``levels``-step
    loop; missing children are masked out of the argmin.
    """

    centers: Sequence[torch.Tensor]   # level l: [n_l, 8] int32
    children: Sequence[torch.Tensor]  # level l: [n_{l-1}, k] int64 into level l (-1 pad); n_{-1}=1 (root)
    word_id: torch.Tensor             # [n_last] int64 word id of bottom-level nodes
    idf: torch.Tensor                 # [V] word weights (idf component under TF_IDF)
    k: int
    levels: int
    n_words: int


def _as_words(a, device):
    """numpy uint32 / int32 descriptor words -> int32 tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a.astype(np.int32), device=device)


def _unpack_bits(desc):
    """[D,8] int32 -> [D,256] float32 bits (bit s of each word is read after
    the shift by masking with 1, so the arithmetic shift does no harm)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.float32)


def _pack_bits(bits):
    """[D,256] bool -> [D,8] int32."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    b = bits.reshape(bits.shape[0], 8, 32).to(torch.int32)
    return torch.sum(b << shifts, dim=-1, dtype=torch.int32)


def _child_dist(desc, cc):
    """[N,8] descriptors against their [N,k,8] candidate centers -> [N,k]."""
    return popcount_words(desc[:, None, :] ^ cc)


def _kmedians_level(desc, assign, n_nodes: int, k: int, generator, iters: int = 8):
    """Split each node's descriptors into k children by Hamming k-medians.

    assign: [D] int64 current node id in [0, n_nodes). Returns
    (child_centers [n_nodes*k, 8], new_assign [D] in [0, n_nodes*k)).
    """
    D = desc.shape[0]
    dev = desc.device
    bits = _unpack_bits(desc)
    ar_k = torch.arange(k, device=dev)

    # init: per node pick k random member descriptors as seeds
    noise = torch.rand((D,), generator=generator, device=generator.device).to(dev)
    order = torch.argsort(assign.to(torch.float64) + noise.to(torch.float64))
    sorted_assign = assign[order].contiguous()
    rank = torch.arange(D, device=dev) - torch.searchsorted(sorted_assign, sorted_assign)
    seed_slot = sorted_assign * k + torch.clamp(rank, max=k - 1)
    centers = torch.zeros((n_nodes * k, 8), dtype=torch.int32, device=dev)
    centers[seed_slot] = desc[order]

    ones = torch.ones((D,), dtype=torch.float32, device=dev)
    child_ids = assign[:, None] * k + ar_k[None, :]
    for _ in range(iters):
        newa = assign * k + torch.argmin(_child_dist(desc, centers[child_ids]), dim=-1)
        # bitwise majority per child
        votes = torch.zeros((n_nodes * k, 256), dtype=torch.float32, device=dev)
        votes = votes.index_add(0, newa, bits)
        cnt = torch.zeros((n_nodes * k,), dtype=torch.float32, device=dev).index_add(0, newa, ones)
        maj = votes > 0.5 * torch.clamp(cnt, min=1.0)[:, None]
        # keep the seed for empty clusters
        centers = torch.where((cnt > 0)[:, None], _pack_bits(maj), centers)
    newa = assign * k + torch.argmin(_child_dist(desc, centers[child_ids]), dim=-1)
    return centers, newa


def train(desc, k: int = 10, levels: int = 4, seed: int = 0, generator=None) -> Vocabulary:
    """Train a k^levels-word vocabulary from [D,8] int32 descriptors. The
    seeds are drawn from ``generator`` (default: a CPU generator seeded with
    ``seed``)."""
    if not isinstance(desc, torch.Tensor):
        desc = _as_words(desc, "cpu")
    if generator is None:
        generator = torch.Generator(device="cpu")
        generator.manual_seed(seed)
    D = desc.shape[0]
    assign = torch.zeros((D,), dtype=torch.int64, device=desc.device)
    centers_all = []
    n_nodes = 1
    for _ in range(levels):
        centers, assign = _kmedians_level(desc, assign, n_nodes, k, generator)
        centers_all.append(centers)
        n_nodes *= k
    # idf from the training corpus: log(D / (1 + df))
    df = torch.zeros((n_nodes,), dtype=torch.float32, device=desc.device).index_add(
        0, assign, torch.ones((D,), dtype=torch.float32, device=desc.device))
    idf = torch.log(max(D, 1.0) / (1.0 + df))
    return Vocabulary(centers=tuple(centers_all), idf=idf, k=k, levels=levels)


def _transform_impl(centers, desc, valid, k: int, levels: int):
    N = desc.shape[0]
    dev = desc.device
    node = torch.zeros((N,), dtype=torch.int64, device=dev)
    mid = node
    ar_k = torch.arange(k, device=dev)
    for l in range(levels):
        child_ids = node[:, None] * k + ar_k[None, :]
        # argmin: the lowest index reaching the minimum
        node = node * k + torch.argmin(_child_dist(desc, centers[l][child_ids]), dim=-1)
        if l == max(levels - 3, 0):
            mid = node  # feature-grouping node (DBoW2 levelsup, scaled to this depth)
    return (torch.where(valid, node, -1).to(torch.int32),
            torch.where(valid, mid, -1).to(torch.int32))


def transform(voc: Vocabulary, desc, valid):
    """[N,8] descriptors -> (word ids [N], mid-level node ids [N]); -1 pad."""
    return _transform_impl(voc.centers, desc, valid, voc.k, voc.levels)


def _transform_tree_impl(centers, children, word_id, desc, valid, k, levels):
    N = desc.shape[0]
    node = torch.zeros((N,), dtype=torch.int64, device=desc.device)  # root
    mid = node
    mid_level = max(levels - 4, 0)  # DBoW2 levelsup=4
    for l in range(levels):
        ch = children[l][node]                       # [N,k]
        cc = centers[l][torch.clamp(ch, 0, centers[l].shape[0] - 1)]
        dist = torch.where(ch >= 0, _child_dist(desc, cc), 1 << 30)
        node = torch.gather(ch, -1, torch.argmin(dist, dim=-1, keepdim=True))[:, 0]
        if l == mid_level:
            mid = node
    word = word_id[torch.clamp(node, 0, word_id.shape[0] - 1)]
    return (torch.where(valid, word, -1).to(torch.int32),
            torch.where(valid, mid, -1).to(torch.int32))


def transform_tree(voc: TreeVocabulary, desc, valid):
    return _transform_tree_impl(
        voc.centers, voc.children, voc.word_id, desc, valid, voc.k, voc.levels
    )


def transform_any(voc, desc, valid):
    """Dispatch over the two vocabulary representations."""
    if isinstance(voc, TreeVocabulary):
        return transform_tree(voc, desc, valid)
    return transform(voc, desc, valid)


def _parse_dbow2_text(path: str):
    """Parse the DBoW2 text format into flat arrays.

    Returns (k, L, scoring, weighting, parent [M], is_leaf [M],
    desc [M,32] uint8, weight [M] f64); node ids are 1..M in file order,
    root = 0.
    """
    with open(path, "r") as f:
        header = f.readline().split()
        k, L, scoring, weighting = (int(x) for x in header[:4])
        body = np.fromfile(f, sep=" ")
    assert body.size % 35 == 0, "malformed DBoW2 text vocabulary"
    rows = body.reshape(-1, 35)
    parent = rows[:, 0].astype(np.int64)
    is_leaf = rows[:, 1] > 0
    desc = rows[:, 2:34].astype(np.uint8)
    weight = rows[:, 34].astype(np.float64)
    return k, L, scoring, weighting, parent, is_leaf, desc, weight


def pack_descriptor_bytes(desc_bytes):
    """[M,32] uint8 -> [M,8] uint32, little-endian within each word: bit b
    of byte i lands at bit position (i%4)*8+b of word i//4, matching this
    package's BRIEF packing (any fixed bijection preserves Hamming
    distances)."""
    b = desc_bytes.reshape(-1, 8, 4).astype(np.uint32)
    return (
        b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
    )


def unpack_descriptor_bytes(desc_words):
    """[M,8] uint32 (or its int32 view) -> [M,32] uint8 (inverse of
    pack_descriptor_bytes)."""
    w = np.ascontiguousarray(np.asarray(desc_words))
    w = w.view(np.uint32) if w.dtype == np.int32 else w.astype(np.uint32)
    out = np.zeros((w.shape[0], 32), np.uint8)
    for j in range(4):
        out[:, j::4] = (w >> (8 * j)) & 0xFF
    return out


def load_dbow2_text(path: str, device="cpu") -> TreeVocabulary:
    """Load a DBoW2 text vocabulary (the ORBvoc.txt format) into a
    level-batched tree on ``device``.

    Word ids match DBoW2's (leaf order of appearance in the file), so BoW
    vectors are comparable with DBoW2's.
    """
    k, L, _scoring, _weighting, parent, is_leaf, desc_b, weight = (
        _parse_dbow2_text(path)
    )
    M = len(parent)
    desc = pack_descriptor_bytes(desc_b)
    # depth of each node (root=0 has depth 0; parents precede children)
    depth = np.zeros(M + 1, np.int32)
    nid = np.arange(1, M + 1)
    for _ in range(L):  # propagate one level per pass (depth <= L)
        depth[nid] = depth[parent] + 1
    # word ids in file order of leaves
    word_of = np.full(M + 1, -1, np.int64)
    leaf_nids = nid[is_leaf]
    word_of[leaf_nids] = np.arange(len(leaf_nids))
    n_words = len(leaf_nids)
    idf = np.zeros(n_words, np.float64)
    idf[word_of[leaf_nids]] = weight[is_leaf]

    # per-level node tables; early leaves get virtual single-child chains
    level_nodes = [nid[depth[nid] == l + 1] for l in range(L)]
    centers, children, chain = [], [], {}  # chain: nid -> local idx at cur level
    prev_count = 1
    prev_local = {0: 0}
    local_l = {}
    for l in range(L):
        nodes_l = level_nodes[l]
        n_real = len(nodes_l)
        # virtual continuations of leaves that ended above this level
        virt = sorted(chain.keys())
        n_l = n_real + len(virt)
        cen = np.zeros((n_l, 8), np.uint32)
        local_l = {}
        for i, nd in enumerate(nodes_l):
            cen[i] = desc[nd - 1]
            local_l[int(nd)] = i
        for j, nd in enumerate(virt):
            cen[n_real + j] = desc[nd - 1]
            local_l[int(nd)] = n_real + j  # same node id, deeper copy
        # children table of the previous level
        ch = np.full((prev_count, k), -1, np.int64)
        fill = np.zeros(prev_count, np.int32)
        for nd in nodes_l:
            p = int(parent[nd - 1])
            pl = prev_local[p] if p in prev_local else chain[p]
            ch[pl, fill[pl]] = local_l[int(nd)]
            fill[pl] += 1
        for nd in virt:
            pl = chain[nd]
            ch[pl, 0] = local_l[int(nd)]
        centers.append(_as_words(cen, device))
        children.append(torch.as_tensor(ch, device=device))
        # set up next level: leaves at this level start/continue chains
        new_chain = {}
        if l < L - 1:
            for nd in nodes_l:
                if is_leaf[nd - 1]:
                    new_chain[int(nd)] = local_l[int(nd)]
            for nd in virt:
                new_chain[int(nd)] = local_l[int(nd)]
        chain = new_chain
        prev_local = {int(nd): local_l[int(nd)] for nd in nodes_l}
        prev_count = n_l
    # bottom-level word ids (real bottom leaves + virtual chain carriers)
    bottom = np.full(prev_count, -1, np.int64)
    for nd, i in local_l.items():
        bottom[i] = word_of[nd]
    return TreeVocabulary(
        centers=tuple(centers), children=tuple(children),
        word_id=torch.as_tensor(bottom, device=device),
        idf=torch.as_tensor(idf.astype(np.float32), device=device),
        k=k, levels=L, n_words=n_words,
    )


def save_dbow2_text(path: str, voc: Vocabulary) -> None:
    """Write a trained (complete-tree) vocabulary in the DBoW2 text format
    (loadable by DBoW2's ``loadFromTextFile``)."""
    k, L = voc.k, voc.levels
    lines = [f"{k} {L} 0 0"]  # L1_NORM, TF_IDF
    idf = voc.idf.cpu().numpy()
    # file node ids: root=0 implicit; levels written in order so parents
    # precede children. Level l node n has parent node n//k of level l-1.
    offset = [1]  # file id of the first node of each level
    for l in range(L):
        offset.append(offset[-1] + voc.centers[l].shape[0])
    for l in range(L):
        cen = unpack_descriptor_bytes(voc.centers[l].cpu().numpy())
        is_leaf = 1 if l == L - 1 else 0
        for n in range(cen.shape[0]):
            pid = 0 if l == 0 else offset[l - 1] + n // k
            w = float(idf[n]) if is_leaf else 0.0
            dtxt = " ".join(str(int(x)) for x in cen[n])
            lines.append(f"{pid} {is_leaf} {dtxt} {w:.6f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def vocabulary_to_numpy(voc) -> dict:
    """Either vocabulary kind as a dict of numpy arrays and ints (centers as
    uint32 words), the form :func:`vocabulary_from_numpy` takes."""
    out = {
        "k": int(voc.k), "levels": int(voc.levels),
        "idf": voc.idf.cpu().numpy(),
        "centers": [c.cpu().numpy().view(np.uint32) for c in voc.centers],
    }
    if isinstance(voc, TreeVocabulary):
        out["children"] = [c.cpu().numpy().astype(np.int32) for c in voc.children]
        out["word_id"] = voc.word_id.cpu().numpy().astype(np.int32)
        out["n_words"] = int(voc.n_words)
    return out


def vocabulary_from_numpy(arrays: dict, device="cpu"):
    """A vocabulary from numpy arrays (a dict as :func:`vocabulary_to_numpy`
    gives, or any object with the same fields, such as a vocabulary trained
    elsewhere): a :class:`TreeVocabulary` when it has ``children``."""
    get = arrays.get if isinstance(arrays, dict) else (lambda k, d=None: getattr(arrays, k, d))
    centers = tuple(_as_words(c, device) for c in get("centers"))
    idf = torch.as_tensor(np.array(get("idf"), np.float32), device=device)
    k, levels = int(get("k")), int(get("levels"))
    if get("children") is None:
        return Vocabulary(centers=centers, idf=idf, k=k, levels=levels)
    return TreeVocabulary(
        centers=centers,
        children=tuple(torch.as_tensor(np.asarray(c, np.int64), device=device)
                       for c in get("children")),
        word_id=torch.as_tensor(np.asarray(get("word_id"), np.int64), device=device),
        idf=idf, k=k, levels=levels, n_words=int(get("n_words")),
    )


def save(path: str, voc: Vocabulary) -> None:
    """Persist a trained vocabulary as a compressed npz."""
    np.savez_compressed(
        path, k=voc.k, levels=voc.levels, idf=voc.idf.cpu().numpy(),
        **{f"centers_{i}": c.cpu().numpy().view(np.uint32)
           for i, c in enumerate(voc.centers)},
    )


def load(path: str, device="cpu") -> Vocabulary:
    data = np.load(path)
    k = int(data["k"])
    levels = int(data["levels"])
    centers = tuple(_as_words(data[f"centers_{i}"], device) for i in range(levels))
    idf = torch.as_tensor(np.asarray(data["idf"], np.float32), device=device)
    return Vocabulary(centers=centers, idf=idf, k=k, levels=levels)


def bow_vector(word, n_words: int, idf):
    """Dense L1-normalized tf-idf vector [V] from word ids [N]."""
    ok = word >= 0
    v = torch.zeros((n_words + 1,), dtype=torch.float32, device=word.device)
    v = v.index_add(0, torch.where(ok, word, n_words).to(torch.int64),
                    ok.to(torch.float32))[:n_words]
    v = v * idf
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def sparse_bow(word, idf):
    """Compact L1-normalized tf-idf representation of one frame's words:
    (word ids [N] sorted unique, -1 pad; values [N]). The sparse analogue
    of :func:`bow_vector` for vocabularies too large for dense [V] vectors
    (frames carry <= N distinct words). Fixed shapes, no host read: the
    unique ids come from a sort and a running count of first occurrences."""
    N = word.shape[0]
    ok_w = word >= 0
    # pads (-1) go to the end so uid stays sorted for searchsorted
    w = torch.where(ok_w, word, _INT32_MAX)
    ws, _ = torch.sort(w)
    first = torch.ones((N,), dtype=torch.bool, device=word.device)
    first[1:] = ws[1:] != ws[:-1]
    rank = torch.cumsum(first, 0) - 1
    uid = torch.full((N,), _INT32_MAX, dtype=w.dtype, device=word.device)
    uid = uid.scatter(0, rank, ws)
    inv = torch.searchsorted(uid, w.contiguous())
    tf = torch.zeros((N,), dtype=torch.float32, device=word.device)
    tf = tf.index_add(0, inv, ok_w.to(torch.float32))
    ok = uid < _INT32_MAX
    val = tf * idf[torch.clamp(uid, 0, idf.shape[0] - 1).to(torch.int64)] * ok
    return torch.where(ok, uid, -1), val / torch.clamp(torch.sum(torch.abs(val)), min=1e-9)


def sparse_l1_scores(kf_wid, kf_wval, q_wid, q_wval, kf_valid):
    """L1 similarity + common-word counts of a sparse query against every
    keyframe's sparse BoW. For L1-normalized a, b,
    1 - 0.5*|a-b|_1 = 0.5 * sum_{w in both} (|a_w| + |b_w| - |a_w - b_w|),
    so only the word intersection matters. Both sides come from
    :func:`sparse_bow`, whose word ids are sorted-unique with -1 end pads,
    so the intersection is a sort-merge join: one searchsorted per keyframe
    word, O(K*Nw*log Nq) time and O(K*Nw) memory."""
    nq = q_wid.shape[0]
    # restore sortedness: sparse_bow pads with -1 AFTER the sorted ids
    q = torch.where(q_wid >= 0, q_wid, _INT32_MAX).to(kf_wid.dtype).contiguous()
    # keyframe pads -> big-1: never equals a real query word nor its pad
    w = torch.where(kf_wid >= 0, kf_wid, _INT32_MAX - 1)
    pos = torch.clamp(torch.searchsorted(q, w), 0, nq - 1)
    hit = (q[pos] == w) & (kf_wid >= 0)
    qv = q_wval[pos]
    inter = torch.where(
        hit, torch.abs(kf_wval) + torch.abs(qv) - torch.abs(kf_wval - qv), 0.0
    )
    scores = 0.5 * torch.sum(inter, dim=-1)
    common = torch.sum(hit, dim=-1, dtype=torch.int32)
    return torch.where(kf_valid, scores, -1.0), torch.where(kf_valid, common, 0)


def l1_score(a, b):
    """DBoW2 L1 similarity: 1 - 0.5*|a-b|_1 for L1-normalized vectors
    (range [0,1], 1 = identical)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b), dim=-1)


def match_by_words(
    word_a, desc_a, valid_a, word_b, desc_b, valid_b, th=50, ratio=0.7
):
    """SearchByBoW equivalent: only descriptor pairs sharing a vocabulary
    word compete (a dense masked argmin with a word-equality mask)."""
    mask = (
        valid_a[:, None]
        & valid_b[None, :]
        & (word_a[:, None] == word_b[None, :])
        & (word_a >= 0)[:, None]
    )
    bi, bd, b2 = best_two(hamming_matrix(desc_a, desc_b), mask)
    ok = _ratio_ok(bd, b2, th, ratio)
    ok = _resolve_one_to_one(ok, bi, bd, desc_b.shape[0])
    return torch.where(ok, bi, -1), torch.where(ok, bd, _BIG)
