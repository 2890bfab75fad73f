"""The query_eval kernel's cull on the CPU: its test (ops/occlusion.box_outside) never
drops a (query, triangle) pair that the plain twin covers, and a CPU emulation of the
kernel's algorithm (a block's list of the valid rows that can reach its queries' box, in
order and in rounds, each on the chain of its t; half-warp boxes and warp-wide skips over
the list) equals the twin bit for bit and counts the kernel's tally.  The kernel itself
is held against the twin, and its tally against the emulation's, on the card by
tests/test_torch_kernels.py and chip_smoke.py.

Inputs are made from seeds with numpy.  Triangles come in four families: random,
slivers (nearly collinear vertices), far (vertices up to 1e6 pixels away) and tiny (sub-
pixel); query boxes are spanned by points on the triangle's edges and vertices, one
float step outside its bounding box, and at -1e9.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_query_scenes as qs  # tests/torch_query_scenes.py: pytest puts tests/ on sys.path
from m3t_tpu_torch.ops import occlusion as oc
from m3t_tpu_torch.ops import raster

FAMILIES = ("random", "sliver", "far", "tiny")


def _triangles(family: str, n: int, rng):
    """(n, 3, 2) float32 pixel-space vertices of one family."""
    if family == "random":
        return rng.uniform(-20, 150, (n, 3, 2)).astype(np.float32)
    if family == "sliver":
        p = rng.uniform(0, 128, (n, 1, 2))
        d = rng.uniform(-60, 60, (n, 1, 2))
        t = np.concatenate([np.zeros((n, 1, 1)), np.ones((n, 1, 1)),
                            rng.uniform(0, 1, (n, 1, 1))], 1)
        normal = np.stack([-d[..., 1], d[..., 0]], -1) / np.linalg.norm(d, axis=-1)[..., None]
        off = rng.choice([0.0, 1e-6, 1e-4, 1e-2], (n, 3, 1)) * rng.choice([-1, 1], (n, 3, 1))
        return (p + t * d + off * normal).astype(np.float32)
    if family == "far":
        v = rng.uniform(-20, 150, (n, 3, 2))
        far = rng.integers(0, 3, n)
        v[np.arange(n), far] = rng.uniform(-1e6, 1e6, (n, 2))
        return v.astype(np.float32)
    p = rng.uniform(0, 128, (n, 1, 2))
    return (p + rng.uniform(-0.5, 0.5, (n, 3, 2))).astype(np.float32)


def _coefficients(verts, rng):
    """(coeffs (n, 12), valid (n,), bbox (n, 4)) of pixel-space vertices, built by
    raster.triangle_coefficients through a camera at a random depth per vertex (the
    vertices project back to within rounding of where they were)."""
    n = len(verts)
    z = rng.uniform(0.4, 3.0, (n, 3, 1)).astype(np.float32)
    cam = np.concatenate([(verts - 64.0) * z / 300.0, z], -1).astype(np.float32)
    soup = raster.triangle_coefficients(torch.as_tensor(cam)[None],
                                        torch.ones((1, n), dtype=torch.int32),
                                        300.0, 300.0, 64.0, 64.0)
    return soup.coeffs[0], soup.valid[0], soup.bbox[0]


def _box_points(verts, bbox, rng, n_points: int = 6):
    """(n, n_points, 2) float32 query points per triangle: on its edges, on its
    vertices, one float step outside its box, at -1e9, or near it."""
    n = len(verts)
    kind = rng.integers(0, 5, (n, n_points))
    edge = rng.integers(0, 3, (n, n_points))
    t = rng.uniform(0, 1, (n, n_points, 1))
    a = verts[np.arange(n)[:, None], edge]
    b = verts[np.arange(n)[:, None], (edge + 1) % 3]
    on_edge = a + t * (b - a)
    on_vertex = verts[np.arange(n)[:, None], edge]
    lo, hi = bbox[:, None, [0, 2]], bbox[:, None, [1, 3]]
    side = rng.integers(0, 2, (n, n_points, 2)).astype(bool)
    beyond = np.where(side, np.nextafter(hi, np.float32(np.inf)),
                      np.nextafter(lo, np.float32(-np.inf)))
    inside = rng.uniform(lo, hi)
    far = np.full((n, n_points, 2), -1e9)
    pts = np.select([kind[..., None] == k for k in range(4)],
                    [on_edge, on_vertex, beyond, far], inside)
    return pts.astype(np.float32)


def _covered(coeffs, u, v):
    """The twin's coverage test, with its rounding: all three edge planes >= 0."""
    e = [(coeffs[..., 3 * k] * u + coeffs[..., 3 * k + 1] * v) + coeffs[..., 3 * k + 2]
         for k in range(3)]
    return torch.minimum(torch.minimum(e[0], e[1]), e[2]) >= 0


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_box_outside_never_drops_a_covered_pixel(family, seed):
    """Boxes spanned by 2-6 points on edges, on vertices, just outside the triangle's
    box and at -1e9: wherever box_outside says out, no pixel of the box (its corners,
    the spanning points, random interior points) is covered."""
    rng = np.random.default_rng([seed, FAMILIES.index(family)])
    verts = _triangles(family, 4000, rng)
    coeffs, valid, bbox = _coefficients(verts, rng)
    pts = _box_points(verts, bbox.numpy(), rng)
    n_span = rng.integers(2, 7, len(verts))
    span = np.where(np.arange(pts.shape[1])[None, :, None] < n_span[:, None, None], pts,
                    pts[:, :1])
    box = torch.as_tensor(np.stack([span[..., 0].min(1), span[..., 0].max(1),
                                    span[..., 1].min(1), span[..., 1].max(1)], -1))
    out = oc.box_outside(coeffs, box)
    corners = [(box[:, i], box[:, j]) for i in (0, 1) for j in (2, 3)]
    interior = [(box[:, 0] + f * (box[:, 1] - box[:, 0]),
                 box[:, 2] + g * (box[:, 3] - box[:, 2]))
                for f, g in rng.uniform(0, 1, (8, 2)).astype(np.float32)]
    spanned = [(torch.as_tensor(span[:, i, 0]), torch.as_tensor(span[:, i, 1]))
               for i in range(span.shape[1])]
    for qu, qv in corners + interior + spanned:
        assert not (out & valid & _covered(coeffs, qu, qv)).any()
    # The test is not vacuous: it culls some boxes and keeps covered ones.
    assert out.any() and (~out & _covered(coeffs, box[:, 0], box[:, 2])).any()


def _random_scene(seed: int, n_scenes: int = 6, n_tri: int = 300, n_query: int = 700):
    """Camera-frame random triangles (about 20 % invalid) and integer queries in and
    around a 128-pixel crop, with some queries grouped in 6x6 windows as the scene
    checks ask them."""
    rng = np.random.default_rng(seed)
    tri = np.empty((n_scenes, n_tri, 3, 3), np.float32)
    tri[..., :2] = rng.uniform(-0.1, 0.1, (n_scenes, n_tri, 3, 2))
    tri[..., 2] = rng.uniform(0.4, 0.8, (n_scenes, n_tri, 3))
    soup = raster.triangle_coefficients(
        torch.as_tensor(tri), torch.as_tensor(rng.integers(1, 1 << 16, (n_scenes, n_tri))),
        300.0, 300.0, 63.5, 63.5)
    valid = soup.valid & torch.as_tensor(rng.random((n_scenes, n_tri)) > 0.2)
    centre = rng.integers(0, 128, (n_scenes, n_query // 36, 1, 2))
    window = np.stack(np.meshgrid(np.arange(6), np.arange(6), indexing="ij"), -1)
    window = (centre + 3 * window.reshape(1, 1, 36, 2)).reshape(n_scenes, -1, 2)
    scattered = rng.integers(-8, 136, (n_scenes, n_query - window.shape[1], 2))
    pixels = np.concatenate([window, scattered], 1).astype(np.int32)
    return (soup.coeffs, valid, soup.ids, torch.as_tensor(pixels[..., 0]),
            torch.as_tensor(pixels[..., 1]))


def _nan_block_scene():
    """The random scene, with more rows than one list (so the kernel culls each
    block's rows), with float queries in three blocks a scene (the last ragged): scene
    0's second block and scene 1's last block all NaN, and scattered NaN, -1e9 and
    infinite queries elsewhere."""
    coeffs, valid, sil, u, v = _random_scene(4, n_scenes=3, n_tri=600, n_query=2200)
    u, v = u.float(), v.float()
    u[0, 1024:2048] = float("nan")
    v[1, 2048:] = float("nan")
    u[2, 3::97], v[2, 5::89] = float("nan"), float("inf")
    u[2, 7::101] = -1e9
    return coeffs, valid, sil, u, v


@pytest.mark.parametrize("case", ["adversarial", "random 0", "random 1", "robots",
                                  "rounds", "nan blocks", "trap"])
def test_kernel_cull_emulation_equals_twin(case):
    """The kernel's algorithm, emulated on the CPU, against the plain twin: inverse
    depths bit for bit, ids exactly, including the adversarial ties, the edge column of
    a half-warp box, NaN rows and NaN, -1e9 and infinite queries, scenes of at most
    512 rows staged whole (every row under the loop bound listed); the kinematic cell's
    robot scenes (each scene's last block ragged); 1500 random triangles of which a
    block keeps more than one list holds (rounds); and blocks whose queries are all NaN,
    which keep no row; and trap_scene, where a row's chain must come from its t and the
    block's box from all of its tiles."""
    if case == "adversarial":
        args, _ = chip_smoke.adversarial_queries(3, "cpu")
    elif case == "robots":
        args = qs.robot_queries("cpu", 1, 2)
    elif case == "rounds":
        args = _random_scene(5, n_scenes=2, n_tri=1500, n_query=1500)
    elif case == "nan blocks":
        args = _nan_block_scene()
    elif case == "trap":
        args = qs.trap_scene(2, "cpu")
    else:
        args = _random_scene(int(case.split()[1]))
    want_inv, want_ids = oc.query_eval_plain(*args)
    inv, ids, tally = qs.culled_query_eval(*args)
    assert torch.equal(inv.view(torch.int32), want_inv.view(torch.int32))
    assert torch.equal(ids, want_ids)
    assert (ids != 0).any() and (ids == 0).any()
    bound = oc.leading_valid_count(args[1])
    assert tally.scanned == int(bound.sum()) * tally.kept.shape[1]
    assert (tally.kept <= bound[:, None]).all()
    if args[0].shape[1] <= qs.LIST_ROWS:
        assert case in ("adversarial", "random 0", "random 1")
        assert (tally.kept == bound[:, None]).all()
    if case == "robots":
        # Q = 7200: seven full blocks and one of 32 queries a scene; the block cull
        # keeps about a third of each scene's rows (PERF.md section 6).
        assert tally.kept.shape[1] == 8 and 1000 < int(bound.min())
        share = tally.kept[:, :7].sum() / (bound.sum() * 7)
        assert 0.2 < share < 0.5 and (tally.kept[:, 7] < tally.kept[:, :7].amin(1)).all()
    if case == "rounds":
        assert int(tally.kept.max()) > qs.LIST_ROWS
    if case == "trap":
        assert (tally.kept == 5).all()
        assert set(ids[:, :768].unique().tolist()) == {0, 22}
        assert set(ids[:, 768:].unique().tolist()) == {0, 26}
    if case == "nan blocks":
        assert tally.kept[0, 1] == 0 and tally.kept[1, 2] == 0
        assert (tally.kept[0, [0, 2]] > 0).all() and (tally.kept[1, :2] > 0).all()


def test_adversarial_case_exercises_ties_and_edges():
    """The adversarial case's expected results, from its construction: the grid where
    only t0's copies cover it answers t0's id at inverse depth 0.5; the u = 40 column
    answers t4 (nearer, its left edge on the column); NaN, -1e9 and infinite queries
    answer no hit."""
    (coeffs, valid, sil, u, v), _ = chip_smoke.adversarial_queries(2, "cpu")
    inv, ids = oc.query_eval_plain(coeffs, valid, sil, u, v)
    on_t0 = (u[0] < 20) & (v[0] < 20) & (u[0] + v[0] <= 48) & (u[0] >= 8) & (v[0] >= 8)
    assert on_t0.sum() > 10
    assert (ids[0][on_t0] == 11).all() and (inv[0][on_t0] == 0.5).all()
    column = (u[0] == 40) & (v[0] <= 60)
    assert column.sum() == 16 and (ids[0][column] == 15).all()
    odd = ~torch.isfinite(u[0]) | ~torch.isfinite(v[0]) | (u[0] == -1e9) | (v[0] == -1e9)
    assert odd.sum() == 16 and (ids[0][odd] == 0).all() and (inv[0][odd] == 0).all()


def test_query_eval_cpu_ignores_cull_and_reads_int_pixels_as_float():
    """On the CPU query_eval is the twin, which has no cull (it walks every triangle
    under the loop bound), and int32 pixels give the results of the same pixels as
    float32."""
    coeffs, valid, sil, u, v = _random_scene(3, n_scenes=2, n_query=200)
    want = oc.query_eval_plain(coeffs, valid, sil, u.float(), v.float())
    got = oc.query_eval(coeffs, valid, sil, u, v)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_query_eval_cpu_counts_no_rows():
    """The block cull's counters belong to the kernel: on the CPU query_eval is the
    twin, which has no cull and counts nothing with the tracer on."""
    from m3t_tpu_torch.utils import timing

    args = qs.trap_scene(2, "cpu")
    timing.reset()
    try:
        with timing.tracing():
            got = oc.query_eval(*args)
            assert timing.report().counters == {}
    finally:
        timing.reset()
    assert all(torch.equal(g, w) for g, w in zip(got, oc.query_eval_plain(*args)))
