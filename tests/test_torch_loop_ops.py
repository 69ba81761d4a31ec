"""The port's place-recognition and loop-closing ops against the reference's.

All on the CPU; inputs come from numpy seeds and go through the JAX function
and its counterpart. Tolerances (float32 on both sides, different op order):

- Sim3 group ops, ``sim3_exp`` / ``sim3_log`` (all four small-angle /
  small-scale branches): 1e-5; Jacobians at ``xi = 0``: 1e-4;
- ``mutual_match``: indices and distances bit-exact;
- ``transform`` (a JAX-trained k=8, 3-level vocabulary carried across) and
  ``transform_tree`` (a ragged tree written in DBoW2 text by the test): word
  ids bit-exact; ``sparse_bow`` ids exact, values 1e-6; ``bow_vector`` 1e-6;
- ``sparse_l1_scores`` / ``score_database``: scores 1e-5, common-word counts
  exact, sparse equal to dense;
- ``horn_sim3`` 1e-4; ``ransac_sim3`` / ``ransac_pnp`` with the reference's
  own draw passed as ``sel``: inlier masks differ in at most 2 entries, pose
  within 1e-3; ``optimize_sim3`` 1e-3; ``epnp_pose`` 1e-3;
- ``optimize_pose_graph`` on the drifted circle of
  ``tests/test_solvers.py``: poses within 1e-3, final cost within 1%;
- ``optimize_pose_graph_dense`` on ``tests/test_solvers.py``'s noisy chain
  with chords (drawn from a numpy seed): poses within 1e-4 of the
  reference's dense solver and within 5e-3 of the port's matrix-free one;
- ``train``: by property (every descriptor's word is its nearest leaf among
  its parent's children; retrieval separates two scenes), not by parity: the
  two packages draw their seeds from different generators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu.models import loop_closing as jlc
from orbslam2_with_quadrics_tpu.ops import camera as jcam
from orbslam2_with_quadrics_tpu.ops import lie as jlie
from orbslam2_with_quadrics_tpu.ops import matching as jmatch
from orbslam2_with_quadrics_tpu.ops import pnp as jpnp
from orbslam2_with_quadrics_tpu.ops import pose_graph as jpg
from orbslam2_with_quadrics_tpu.ops import sim3solver as jsim
from orbslam2_with_quadrics_tpu.ops import vocab as jvocab
from orbslam2_with_quadrics_tpu_torch.models import loop_closing as lc
from orbslam2_with_quadrics_tpu_torch.ops import lie, matching, pnp, pose_graph, sim3solver, vocab


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (restored afterwards): the
    suite runs several worker processes on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a)


def J(a):
    return jnp.asarray(np.asarray(a))


def N(a):
    return np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)


KC = np.asarray([400.0, 400.0, 320.0, 240.0], np.float32)


def rand_desc(rng, n):
    return rng.randint(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def random_sim3(rng, n):
    xi = (rng.randn(n, 7) * [0.5, 0.5, 0.5, 1.0, 1.0, 1.0, 0.3]).astype(np.float32)
    return np.array(jlie.sim3_exp(jnp.asarray(xi))), xi


def branch_tangents(rng):
    """Tangents on each of ``_sim3_W``'s four branches."""
    g = (rng.randn(16, 7) * [0.5, 0.5, 0.5, 1.0, 1.0, 1.0, 0.3]).astype(np.float32)
    small_t = g.copy()
    small_t[:, :3] *= 1e-6
    small_s = g.copy()
    small_s[:, 6] *= 1e-7
    both = g.copy()
    both[:, :3] *= 1e-6
    both[:, 6] *= 1e-7
    return np.concatenate([g, small_t, small_s, both, np.zeros((1, 7), np.float32)])


# ---------------------------------------------------------------------------
# Sim3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["compose", "inverse", "apply", "exp", "log", "retract",
                                "se3_round_trip", "accessors", "W"])
def test_sim3_matches_reference(fn):
    rng = np.random.RandomState(0)
    A, _ = random_sim3(rng, 64)
    B, _ = random_sim3(rng, 64)
    p = rng.randn(64, 3).astype(np.float32)
    xi = branch_tangents(rng)
    if fn == "compose":
        got, ref = lie.sim3_compose(T(A), T(B)), jlie.sim3_compose(J(A), J(B))
    elif fn == "inverse":
        got, ref = lie.sim3_inverse(T(A)), jlie.sim3_inverse(J(A))
    elif fn == "apply":
        got, ref = lie.sim3_apply(T(A), T(p)), jlie.sim3_apply(J(A), J(p))
    elif fn == "exp":
        got, ref = lie.sim3_exp(T(xi)), jlie.sim3_exp(J(xi))
    elif fn == "log":
        S = np.array(jlie.sim3_exp(J(xi)))
        got, ref = lie.sim3_log(T(S)), jlie.sim3_log(J(S))
        np.testing.assert_allclose(N(got), xi, atol=2e-5)
    elif fn == "retract":
        d = xi[:64]
        got, ref = lie.sim3_retract(T(A), T(d)), jax.vmap(jlie.sim3_retract)(J(A), J(d))
    elif fn == "se3_round_trip":
        s = np.abs(rng.randn(64)).astype(np.float32) + 0.5
        got = lie.sim3_to_se3(lie.sim3_from_se3(T(A[:, :7]), T(s)))
        ref = jlie.sim3_to_se3(jlie.sim3_from_se3(J(A[:, :7]), J(s)))
        np.testing.assert_array_equal(N(lie.sim3_from_se3(T(A[:, :7])))[:, 7], 1.0)
    elif fn == "accessors":
        S = lie.sim3_make(T(A[:, :4]), T(A[:, 4:7]), T(A[:, 7]))
        np.testing.assert_array_equal(N(S), A)
        np.testing.assert_array_equal(N(lie.sim3_quat(S)), A[:, :4])
        np.testing.assert_array_equal(N(lie.sim3_trans(S)), A[:, 4:7])
        np.testing.assert_array_equal(N(lie.sim3_scale(S)), A[:, 7])
        got, ref = lie.sim3_identity((3,)), jlie.sim3_identity((3,))
    else:
        got = lie._sim3_W(T(xi[:, :3]), T(xi[:, 6]))
        ref = jax.vmap(jlie._sim3_W)(J(xi[:, :3]), J(xi[:, 6]))
    assert N(got).dtype == np.float32
    np.testing.assert_allclose(N(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("case", ["general", "consistent"])
def test_edge_jacobians_at_zero_match_reference(case):
    """d edge_residual / d xi at xi = 0 through the retraction, for both
    endpoints; ``consistent`` measurements put the residual (and every
    small-angle branch) at zero."""
    rng = np.random.RandomState(1)
    Si, _ = random_sim3(rng, 12)
    Sj, _ = random_sim3(rng, 12)
    if case == "general":
        meas, _ = random_sim3(rng, 12)
    else:
        meas = np.array(jax.vmap(lambda a, b: jlie.sim3_compose(b, jlie.sim3_inverse(a)))(
            J(Si), J(Sj)))

    def jref(si, sj, me):
        z = jnp.zeros(7, jnp.float32)
        return (jax.jacfwd(lambda x: jpg.edge_residual(jlie.sim3_retract(si, x), sj, me))(z),
                jax.jacfwd(lambda x: jpg.edge_residual(si, jlie.sim3_retract(sj, x), me))(z))

    ref_i, ref_j = jax.vmap(jref)(J(Si), J(Sj), J(meas))
    K = 12
    Sp = torch.cat([T(Si), T(Sj)])
    ei, ej = torch.arange(K), torch.arange(K, 2 * K)
    r, Ji, Jj, _ = pose_graph._edge_terms(Sp, ei, ej, T(meas), torch.ones(K),
                                          torch.zeros(2 * K))
    np.testing.assert_allclose(N(Ji), np.asarray(ref_i), atol=1e-4)
    np.testing.assert_allclose(N(Jj), np.asarray(ref_j), atol=1e-4)
    ref_r = jax.vmap(jpg.edge_residual)(J(Si), J(Sj), J(meas))
    np.testing.assert_allclose(N(r), np.asarray(ref_r), atol=1e-5)


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(96, 96), (64, 128), (128, 80)], ids=str)
def test_mutual_match_bit_exact(shape):
    na, nb = shape
    rng = np.random.RandomState(2)
    a = rand_desc(rng, na)
    b = rand_desc(rng, nb)
    # half of b are noisy copies of rows of a, some rows exact duplicates
    n = min(na, nb) // 2
    src = rng.permutation(na)[:n]
    flips = (rng.rand(n, 8, 32) < 0.06)
    b[:n] = a[src] ^ (flips * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    b[n] = b[0]
    va = rng.rand(na) > 0.1
    vb = rng.rand(nb) > 0.1
    for th, ratio in ((matching.TH_LOW, 0.75), (matching.TH_HIGH, 0.9)):
        gi, gd = matching.mutual_match(T(a), T(va), T(b), T(vb), th=th, ratio=ratio)
        ri, rd = jmatch.mutual_match(J(a), J(va), J(b), J(vb), th=th, ratio=ratio)
        np.testing.assert_array_equal(N(gi), np.asarray(ri))
        np.testing.assert_array_equal(N(gd), np.asarray(rd))
    assert (N(gi) >= 0).sum() >= n // 3


# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vocab():
    """A JAX-trained k=8, 3-level vocabulary and its carried-across twin."""
    rng = np.random.RandomState(3)
    jvoc = jvocab.train(J(rand_desc(rng, 2048)), k=8, levels=3)
    voc = vocab.vocabulary_from_numpy(
        dict(centers=[np.asarray(c) for c in jvoc.centers], idf=np.asarray(jvoc.idf),
             k=jvoc.k, levels=jvoc.levels))
    return jvoc, voc


def write_ragged_tree(path, rng):
    """A k=3, L=3 DBoW2 text tree with early leaves and nodes with fewer
    than k children; returns the number of words."""
    def d():
        return " ".join(str(int(x)) for x in rng.randint(0, 256, 32))

    lines = ["3 3 0 0"]
    # depth 1: node1 (early leaf), node2, node3
    lines += [f"0 1 {d()} 0.5", f"0 0 {d()} 0.0", f"0 0 {d()} 0.0"]
    # depth 2: node2 -> 4 (leaf), 5; node3 -> 6, 7, 8 (leaf)
    lines += [f"2 1 {d()} 0.7", f"2 0 {d()} 0.0",
              f"3 0 {d()} 0.0", f"3 0 {d()} 0.0", f"3 1 {d()} 1.1"]
    # depth 3: 5 -> 9, 10; 6 -> 11; 7 -> 12, 13, 14
    lines += [f"5 1 {d()} 0.9", f"5 1 {d()} 1.3", f"6 1 {d()} 0.4",
              f"7 1 {d()} 0.6", f"7 1 {d()} 0.8", f"7 1 {d()} 1.0"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 9


def test_transform_words_bit_exact(jax_vocab):
    jvoc, voc = jax_vocab
    rng = np.random.RandomState(4)
    desc = rand_desc(rng, 300)
    valid = rng.rand(300) > 0.15
    gw, gm = vocab.transform(voc, T(desc), T(valid))
    rw, rm = jvocab.transform(jvoc, J(desc), J(valid))
    assert gw.dtype == torch.int32
    np.testing.assert_array_equal(N(gw), np.asarray(rw))
    np.testing.assert_array_equal(N(gm), np.asarray(rm))
    gw2, _ = vocab.transform_any(voc, T(desc), T(valid))
    np.testing.assert_array_equal(N(gw2), N(gw))


def test_transform_tree_words_bit_exact(tmp_path):
    rng = np.random.RandomState(5)
    path = str(tmp_path / "ragged.txt")
    n_words = write_ragged_tree(path, rng)
    jt = jvocab.load_dbow2_text(path)
    tv = vocab.load_dbow2_text(path)
    assert tv.n_words == jt.n_words == n_words and tv.k == 3 and tv.levels == 3
    np.testing.assert_allclose(N(tv.idf), np.asarray(jt.idf), atol=1e-7)
    for a, b in zip(tv.centers, jt.centers):
        np.testing.assert_array_equal(N(a).view(np.uint32), np.asarray(b))
    for a, b in zip(tv.children, jt.children):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    desc = rand_desc(rng, 400)
    valid = rng.rand(400) > 0.1
    gw, gm = vocab.transform_any(tv, T(desc), T(valid))
    rw, rm = jvocab.transform_tree(jt, J(desc), J(valid))
    np.testing.assert_array_equal(N(gw), np.asarray(rw))
    np.testing.assert_array_equal(N(gm), np.asarray(rm))
    assert len(np.unique(N(gw)[valid])) >= 6
    # the tree kind survives the numpy round trip
    tv2 = vocab.vocabulary_from_numpy(vocab.vocabulary_to_numpy(tv))
    assert isinstance(tv2, vocab.TreeVocabulary)
    gw2, _ = vocab.transform_tree(tv2, T(desc), T(valid))
    np.testing.assert_array_equal(N(gw2), N(gw))


def test_dbow2_text_and_npz_round_trip(tmp_path, jax_vocab):
    """save_dbow2_text -> load_dbow2_text and save -> load reproduce the
    word assignment; the reference reads the port's text file the same way."""
    _, voc = jax_vocab
    rng = np.random.RandomState(6)
    desc, valid = rand_desc(rng, 128), np.ones(128, bool)
    w0, _ = vocab.transform(voc, T(desc), T(valid))
    txt = str(tmp_path / "voc.txt")
    vocab.save_dbow2_text(txt, voc)
    w1, _ = vocab.transform_tree(vocab.load_dbow2_text(txt), T(desc), T(valid))
    np.testing.assert_array_equal(N(w1), N(w0))
    wj, _ = jvocab.transform_tree(jvocab.load_dbow2_text(txt), J(desc), J(valid))
    np.testing.assert_array_equal(np.asarray(wj), N(w0))
    npz = str(tmp_path / "voc.npz")
    vocab.save(npz, voc)
    back = vocab.load(npz)
    w2, _ = vocab.transform(back, T(desc), T(valid))
    np.testing.assert_array_equal(N(w2), N(w0))
    np.testing.assert_array_equal(np.asarray(jvocab.load(npz).centers[2]),
                                  N(voc.centers[2]).view(np.uint32))
    b = rng.randint(0, 256, (50, 32)).astype(np.uint8)
    np.testing.assert_array_equal(
        vocab.unpack_descriptor_bytes(vocab.pack_descriptor_bytes(b)), b)
    np.testing.assert_array_equal(vocab.pack_descriptor_bytes(b),
                                  jvocab.pack_descriptor_bytes(b))


def frame_words(jvoc, rng, n, n_frames, p_valid=0.8):
    out = []
    for _ in range(n_frames):
        valid = rng.rand(n) < p_valid
        w, _ = jvocab.transform(jvoc, J(rand_desc(rng, n)), J(valid))
        out.append(np.array(w))
    return out


def test_bow_vectors_match_reference(jax_vocab):
    jvoc, voc = jax_vocab
    rng = np.random.RandomState(7)
    for w in frame_words(jvoc, rng, 200, 3) + [np.full(200, -1, np.int32)]:
        # repeated words exercise the tf accumulation
        w[50:100] = w[:50]
        gid, gval = vocab.sparse_bow(T(w), voc.idf)
        rid, rval = jvocab.sparse_bow(J(w), jvoc.idf)
        np.testing.assert_array_equal(N(gid), np.asarray(rid))
        np.testing.assert_allclose(N(gval), np.asarray(rval), atol=1e-6)
        gb = vocab.bow_vector(T(w), voc.n_words, voc.idf)
        rb = jvocab.bow_vector(J(w), jvoc.n_words, jvoc.idf)
        np.testing.assert_allclose(N(gb), np.asarray(rb), atol=1e-6)
        np.testing.assert_allclose(N(vocab.l1_score(gb, gb)), 1.0 if (w >= 0).any() else 1.0,
                                   atol=1e-5)


def test_database_scores_match_reference_and_sparse_equals_dense(jax_vocab):
    jvoc, voc = jax_vocab
    rng = np.random.RandomState(8)
    words = frame_words(jvoc, rng, 160, 7)
    words[3][:80] = words[0][:80]           # a keyframe sharing words with the query
    kf_valid = np.array([1, 1, 1, 1, 0, 1, 1], bool)
    jb = jnp.stack([jvocab.bow_vector(J(w), jvoc.n_words, jvoc.idf) for w in words])
    js = [jvocab.sparse_bow(J(w), jvoc.idf) for w in words]
    ref_d = jlc.score_database(jb, jb[0], J(kf_valid))
    ref_s = jvocab.sparse_l1_scores(jnp.stack([a for a, _ in js]), jnp.stack([b for _, b in js]),
                                    js[0][0], js[0][1], J(kf_valid))
    tb = torch.stack([vocab.bow_vector(T(w), voc.n_words, voc.idf) for w in words])
    ts = [vocab.sparse_bow(T(w), voc.idf) for w in words]
    got_d = lc.score_database(tb, tb[0], T(kf_valid))
    got_s = vocab.sparse_l1_scores(torch.stack([a for a, _ in ts]),
                                   torch.stack([b for _, b in ts]), ts[0][0], ts[0][1],
                                   T(kf_valid))
    for got, ref in ((got_d, ref_d), (got_s, ref_s), (got_s, ref_d)):
        np.testing.assert_allclose(N(got[0]), np.asarray(ref[0]), atol=1e-5)
        np.testing.assert_array_equal(N(got[1]), np.asarray(ref[1]))
    assert N(got_s[0])[4] == -1.0 and N(got_s[1])[4] == 0
    assert N(got_s[0])[3] > 2 * np.delete(N(got_s[0]), [0, 3]).max()


def test_match_by_words_bit_exact(jax_vocab):
    jvoc, voc = jax_vocab
    rng = np.random.RandomState(9)
    a = rand_desc(rng, 120)
    flips = (rng.rand(120, 8, 32) < 0.03)
    b = a[rng.permutation(120)] ^ (flips * (1 << np.arange(32, dtype=np.uint64))).sum(
        -1).astype(np.uint32)
    va, vb = rng.rand(120) > 0.1, rng.rand(120) > 0.1
    wa, _ = jvocab.transform(jvoc, J(a), J(va))
    wb, _ = jvocab.transform(jvoc, J(b), J(vb))
    ri, rd = jvocab.match_by_words(wa, J(a), J(va), wb, J(b), J(vb))
    gi, gd = vocab.match_by_words(T(np.asarray(wa)), T(a), T(va), T(np.asarray(wb)), T(b), T(vb))
    np.testing.assert_array_equal(N(gi), np.asarray(ri))
    np.testing.assert_array_equal(N(gd), np.asarray(rd))
    assert (N(gi) >= 0).sum() > 10


def test_train_by_property():
    """Every descriptor's word is the nearest child at every level of its
    own descent, the idf follows the training counts, and retrieval
    separates two scenes."""
    rng = np.random.RandomState(10)
    protos = rand_desc(rng, 40)

    def scene(ids, n):
        base = protos[rng.choice(ids, n)]
        flips = rng.rand(n, 8, 32) < 0.04
        return base ^ (flips * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)

    train_desc = np.concatenate([scene(np.arange(40), 1500), rand_desc(rng, 500)])
    gen = torch.Generator().manual_seed(0)
    voc = vocab.train(T(train_desc), k=6, levels=3, generator=gen)
    assert [c.shape[0] for c in voc.centers] == [6, 36, 216] and voc.n_words == 216
    d = T(train_desc)
    w, _ = vocab.transform(voc, d, torch.ones(len(d), dtype=torch.bool))
    w = w.to(torch.int64)
    for lvl in range(3):
        node = w // (6 ** (2 - lvl))
        sib = (node // 6)[:, None] * 6 + torch.arange(6)[None, :]
        dist = matching.popcount_words(d[:, None, :] ^ voc.centers[lvl][sib])
        own = torch.gather(dist, 1, (node % 6)[:, None])[:, 0]
        assert bool(torch.all(own == dist.min(dim=1).values))
    df = np.bincount(N(w), minlength=216)
    np.testing.assert_allclose(N(voc.idf), np.log(len(d) / (1.0 + df)), atol=1e-5)
    # the default generator is seeded: two trainings agree
    v1, v2 = vocab.train(T(train_desc), k=4, levels=2), vocab.train(T(train_desc), k=4, levels=2)
    np.testing.assert_array_equal(N(v1.centers[1]), N(v2.centers[1]))

    ok = torch.ones(200, dtype=torch.bool)

    def bow(ids):
        ww, _ = vocab.transform(voc, T(scene(ids, 200)), ok)
        return vocab.bow_vector(ww, voc.n_words, voc.idf)

    a1, a2, b1 = bow(np.arange(20)), bow(np.arange(20)), bow(np.arange(20, 40))
    assert float(vocab.l1_score(a1, a2)) > float(vocab.l1_score(a1, b1)) + 0.1


# ---------------------------------------------------------------------------
# Sim3 solver
# ---------------------------------------------------------------------------

def sim3_scene(rng, n=64, outliers=0.2):
    p1 = rng.uniform([-2.0, -1.5, 3.0], [2.0, 1.5, 9.0], (n, 3)).astype(np.float32)
    S_true = np.array(jlie.sim3_exp(J(np.asarray([0.05, -0.03, 0.08, 0.4, -0.1, 0.2, 0.15],
                                                 np.float32))))
    p2_true = np.array(jlie.sim3_apply(J(S_true), J(p1)))
    bad = rng.rand(n) < outliers
    p2 = np.where(bad[:, None], p2_true + 2.0 * rng.randn(n, 3), p2_true).astype(np.float32)
    uv1 = np.array(jcam.project(J(KC), J(p1))[0])
    uv2 = np.array(jcam.project(J(KC), J(p2_true))[0])
    return p1, p2, uv1, uv2, S_true, bad


def jax_draw(key, valid, n_hyp, size):
    """The minimal sets the reference draws inside ransac_sim3 / ransac_pnp."""
    gum = -jnp.log(-jnp.log(jax.random.uniform(key, (n_hyp, valid.shape[0]),
                                               minval=1e-9, maxval=1.0)))
    return np.asarray(jax.lax.top_k(jnp.where(J(valid)[None, :], gum, -jnp.inf), size)[1])


@pytest.mark.parametrize("fix_scale", [False, True], ids=["free", "fixed"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_horn_sim3_matches_reference(fix_scale, weighted):
    rng = np.random.RandomState(11)
    p1, p2, *_ = sim3_scene(rng, outliers=0.0)
    w = (rng.rand(64) > 0.3).astype(np.float32) if weighted else None
    got = sim3solver.horn_sim3(T(p1), T(p2), None if w is None else T(w), fix_scale=fix_scale)
    ref = jsim.horn_sim3(J(p1), J(p2), None if w is None else J(w), fix_scale=fix_scale)
    np.testing.assert_allclose(N(got), np.asarray(ref), atol=1e-4)
    # a batch of minimal sets, as RANSAC uses it
    sel = np.stack([rng.permutation(64)[:3] for _ in range(32)])
    gb = sim3solver.horn_sim3(T(p1[sel]), T(p2[sel]), fix_scale=fix_scale)
    rb = jax.vmap(lambda i: jsim.horn_sim3(J(p1)[i], J(p2)[i], fix_scale=fix_scale))(J(sel))
    ok = np.all(np.isfinite(np.asarray(rb)), axis=1)
    np.testing.assert_allclose(N(gb)[ok], np.asarray(rb)[ok], atol=2e-3)


@pytest.mark.parametrize("fix_scale", [False, True], ids=["free", "fixed"])
def test_ransac_sim3_matches_reference_on_its_draw(fix_scale):
    rng = np.random.RandomState(12)
    p1, p2, uv1, uv2, S_true, bad = sim3_scene(rng)
    n = len(p1)
    valid = rng.rand(n) > 0.1
    s1 = (1.0 + rng.rand(n)).astype(np.float32)
    s2 = (1.0 + rng.rand(n)).astype(np.float32)
    rS, rinl, rn = jsim.ransac_sim3(J(p1), J(p2), J(valid), J(KC), J(KC), J(uv1), J(uv2),
                                    J(s1), J(s2), fix_scale=fix_scale)
    sel = jax_draw(jax.random.PRNGKey(0), valid, 128, 3)
    gS, ginl, gn = sim3solver.ransac_sim3(T(p1), T(p2), T(valid), T(KC), T(KC), T(uv1), T(uv2),
                                          T(s1), T(s2), sel=T(sel), fix_scale=fix_scale)
    assert (N(ginl) != np.asarray(rinl)).sum() <= 2
    assert abs(int(gn) - int(rn)) <= 2
    np.testing.assert_allclose(N(gS), np.asarray(rS), atol=1e-3)
    if not fix_scale:
        assert int(gn) > 0.7 * 0.75 * valid.sum()
    # without ``sel`` the draw comes from the generator: still a good model
    gS2, _, gn2 = sim3solver.ransac_sim3(
        T(p1), T(p2), T(valid), T(KC), T(KC), T(uv1), T(uv2), T(s1), T(s2),
        generator=torch.Generator().manual_seed(1), fix_scale=fix_scale)
    assert int(gn2) >= int(gn) - 3


@pytest.mark.parametrize("fix_scale", [False, True], ids=["free", "fixed"])
def test_optimize_sim3_matches_reference(fix_scale):
    rng = np.random.RandomState(13)
    p1, p2, uv1, uv2, S_true, _ = sim3_scene(rng, outliers=0.1)
    n = len(p1)
    valid = rng.rand(n) > 0.1
    S0 = np.array(jlie.sim3_retract(J(S_true), J(np.asarray(
        [0.02, -0.01, 0.03, 0.05, 0.02, -0.04, 0.0 if fix_scale else 0.05], np.float32))))
    is1 = (0.5 + rng.rand(n)).astype(np.float32)
    is2 = (0.5 + rng.rand(n)).astype(np.float32)
    rS, rinl, rn = jsim.optimize_sim3(J(S0), J(p1), J(p2), J(valid), J(KC), J(KC), J(uv1),
                                      J(uv2), J(is1), J(is2), fix_scale=fix_scale)
    gS, ginl, gn = sim3solver.optimize_sim3(T(S0), T(p1), T(p2), T(valid), T(KC), T(KC), T(uv1),
                                            T(uv2), T(is1), T(is2), fix_scale=fix_scale)
    np.testing.assert_allclose(N(gS), np.asarray(rS), atol=1e-3)
    assert (N(ginl) != np.asarray(rinl)).sum() <= 2 and abs(int(gn) - int(rn)) <= 2
    if fix_scale:
        assert abs(float(gS[7]) - float(S0[7])) < 1e-6


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------

def pnp_scene(rng, n=96, outliers=0.3):
    pw = rng.uniform([-2.0, -1.5, 4.0], [2.0, 1.5, 10.0], (n, 3)).astype(np.float32)
    T_true = np.array(jlie.se3_exp(J(np.asarray([0.1, -0.05, 0.15, 0.3, -0.2, 0.1],
                                                np.float32))))
    uv = np.array(jcam.project(J(KC), jlie.se3_apply(J(T_true), J(pw)))[0])
    bad = rng.rand(n) < outliers
    uv = np.where(bad[:, None], uv + 60.0 * rng.randn(n, 2), uv).astype(np.float32)
    return pw, uv, T_true, bad


def pose_err(a, b):
    return float(jnp.linalg.norm(jlie.se3_log(jlie.se3_compose(J(N(a)), jlie.se3_inverse(J(N(b)))))))


def test_epnp_pose_matches_reference():
    rng = np.random.RandomState(14)
    pw, uv, T_true, _ = pnp_scene(rng, outliers=0.0)
    w = (rng.rand(len(pw)) > 0.3).astype(np.float32)
    for ww in (None, w):
        got = pnp.epnp_pose(T(pw), T(uv), T(KC), None if ww is None else T(ww))
        ref = jpnp.epnp_pose(J(pw), J(uv), J(KC), None if ww is None else J(ww))
        assert pose_err(got, ref) < 1e-3 and pose_err(got, T_true) < 1e-3
    # clean minimal sets as one batch: the pose, not the null-space vectors
    sel = np.stack([rng.permutation(len(pw))[:4] for _ in range(24)])
    gb = pnp.epnp_pose(T(pw[sel]), T(uv[sel]), T(KC))
    rb = jax.vmap(lambda i: jpnp.epnp_pose(J(pw)[i], J(uv)[i], J(KC)))(J(sel))
    assert gb.shape == (24, 7) and bool(torch.all(torch.isfinite(gb)))
    close = [pose_err(g, r) < 1e-2 for g, r in zip(gb, np.asarray(rb))]
    assert np.mean(close) >= 0.8
    # a degenerate set (one point four times) gives a finite pose, not NaN
    deg = pnp.epnp_pose(T(np.repeat(pw[:1], 4, 0)), T(np.repeat(uv[:1], 4, 0)), T(KC))
    assert bool(torch.all(torch.isfinite(deg)))


def test_ransac_pnp_matches_reference_on_its_draw():
    rng = np.random.RandomState(15)
    pw, uv, T_true, bad = pnp_scene(rng)
    n = len(pw)
    valid = rng.rand(n) > 0.05
    is2 = (0.5 + rng.rand(n)).astype(np.float32)
    rT, rinl, rn = jpnp.ransac_pnp(J(pw), J(uv), J(valid), J(KC), J(is2))
    sel = jax_draw(jax.random.PRNGKey(0), valid, 256, 4)
    gT, ginl, gn = pnp.ransac_pnp(T(pw), T(uv), T(valid), T(KC), T(is2), sel=T(sel))
    assert (N(ginl) != np.asarray(rinl)).sum() <= 2 and abs(int(gn) - int(rn)) <= 2
    assert pose_err(gT, rT) < 1e-3
    assert pose_err(gT, T_true) < 0.01 and N(ginl)[~bad & valid].mean() > 0.9
    gT2, _, gn2 = pnp.ransac_pnp(T(pw), T(uv), T(valid), T(KC), T(is2),
                                 generator=torch.Generator().manual_seed(2))
    assert pose_err(gT2, T_true) < 0.01 and int(gn2) >= int(gn) - 3


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def drifted_circle(n=12):
    """The chain of ``tests/test_solvers.py::test_pose_graph_closes_loop``."""
    step = jnp.asarray([0.0, 0.0, 2 * np.pi / n, 0.5, 0.0, 0.0, 0.0])
    S_true = [jlie.sim3_identity()]
    for _ in range(1, n):
        S_true.append(jlie.sim3_compose(jlie.sim3_exp(step), S_true[-1]))
    S_true = jnp.stack(S_true)
    drift = jlie.sim3_exp(jnp.asarray([0.0, 0.0, 0.01, 0.02, 0.0, 0.0, 0.005]))
    S_est = [S_true[0]]
    for i in range(1, n):
        rel = jlie.sim3_compose(S_true[i], jlie.sim3_inverse(S_true[i - 1]))
        S_est.append(jlie.sim3_compose(jlie.sim3_compose(drift, rel), S_est[-1]))
    S_est = jnp.stack(S_est)
    ei = np.arange(n - 1)
    ej = np.arange(1, n)
    meas = jax.vmap(lambda i, j: jlie.sim3_compose(S_est[j], jlie.sim3_inverse(S_est[i])))(
        J(ei), J(ej))
    loop_meas = jlie.sim3_compose(S_true[0], jlie.sim3_inverse(S_true[n - 1]))
    ei = np.concatenate([ei, [n - 1]]).astype(np.int32)
    ej = np.concatenate([ej, [0]]).astype(np.int32)
    meas = jnp.concatenate([meas, loop_meas[None]])
    fixed = np.zeros(n, np.float32)
    fixed[0] = 1.0
    return (np.asarray(S_est), ei, ej, np.asarray(meas), np.ones(n, np.float32), fixed,
            np.asarray(S_true))


def test_optimize_pose_graph_matches_reference():
    S_est, ei, ej, meas, w, fixed, S_true = drifted_circle()
    ref = jpg.optimize_pose_graph(J(S_est), J(ei), J(ej), J(meas), J(w), J(fixed), iters=25)
    got = pose_graph.optimize_pose_graph(T(S_est), T(ei), T(ej), T(meas), T(w), T(fixed),
                                         iters=25)
    np.testing.assert_allclose(N(got), np.asarray(ref), atol=1e-3)
    c_ref = float(jpg._graph_cost(ref, J(ei), J(ej), J(meas), J(w)))
    c_got = float(pose_graph._graph_cost(got, T(ei).long(), T(ej).long(), T(meas), T(w)))
    c_0 = float(pose_graph._graph_cost(T(S_est), T(ei).long(), T(ej).long(), T(meas), T(w)))
    assert abs(c_got - c_ref) <= 0.01 * c_ref + 1e-9 and c_got < 0.3 * c_0
    np.testing.assert_array_equal(N(got)[0], S_est[0])    # the gauge stayed put
    n = len(S_est)
    e0 = np.linalg.norm(N(lie.sim3_log(lie.sim3_compose(
        T(S_est[n - 1]), lie.sim3_inverse(T(S_true[n - 1]))))))
    e1 = np.linalg.norm(N(lie.sim3_log(lie.sim3_compose(
        got[n - 1], lie.sim3_inverse(T(S_true[n - 1]))))))
    assert e1 < 0.5 * e0


def test_pose_graph_zero_residual_is_a_fixed_point():
    rng = np.random.RandomState(16)
    S, _ = random_sim3(rng, 5)
    ei, ej = np.arange(4), np.arange(1, 5)
    meas = np.array(jax.vmap(lambda a, b: jlie.sim3_compose(b, jlie.sim3_inverse(a)))(
        J(S[ei]), J(S[ej])))
    fixed = np.zeros(5, np.float32)
    fixed[0] = 1.0
    # zero-weight padding edges are inert
    ei_p, ej_p = np.concatenate([ei, [0, 0]]), np.concatenate([ej, [0, 0]])
    meas_p = np.concatenate([meas, np.array(jlie.sim3_identity((2,)))])
    w_p = np.asarray([1, 1, 1, 1, 0, 0], np.float32)
    got = pose_graph.optimize_pose_graph(T(S), T(ei_p), T(ej_p), T(meas_p), T(w_p), T(fixed),
                                         iters=5)
    np.testing.assert_allclose(N(got), S, atol=2e-3)


def test_optimize_pose_graph_dense_matches_reference():
    """``tests/test_solvers.py::test_pose_graph_matrix_free_matches_dense``'s
    graph: a chain of 10 Sim3 poses with three chords, a noisy start and
    the first pose held."""
    rng = np.random.RandomState(3)
    n = 10
    S_true = np.array(jlie.sim3_exp(J(rng.randn(n, 7).astype(np.float32) * 0.4)))
    ei = np.asarray(list(range(n - 1)) + [0, 2, 4], np.int32)
    ej = np.asarray(list(range(1, n)) + [5, 7, 9], np.int32)
    meas = np.array(jax.vmap(lambda i, j: jlie.sim3_compose(
        J(S_true)[j], jlie.sim3_inverse(J(S_true)[i])))(J(ei), J(ej)))
    S0 = np.array(jax.vmap(jlie.sim3_retract)(
        J(S_true), J(rng.randn(n, 7).astype(np.float32) * 0.1)))
    S0[0] = S_true[0]
    w = np.ones(len(ei), np.float32)
    fixed = np.zeros(n, np.float32)
    fixed[0] = 1.0
    ref = jpg.optimize_pose_graph_dense(J(S0), J(ei), J(ej), J(meas), J(w), J(fixed), iters=15)
    got = pose_graph.optimize_pose_graph_dense(T(S0), T(ei), T(ej), T(meas), T(w), T(fixed),
                                               iters=15)
    cg = pose_graph.optimize_pose_graph(T(S0), T(ei), T(ej), T(meas), T(w), T(fixed), iters=15)
    np.testing.assert_allclose(N(got), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(N(got), N(cg), atol=5e-3)
    np.testing.assert_allclose(N(got), S_true, atol=5e-3)   # the graph's truth

