"""Parity of the port's image pyramid, K1 twin and ORB extractor with the
reference (JAX on the CPU, under jit).

Tolerances and their reasons:
- constant matrices and the BRIEF pattern: exactly equal (same numpy code);
- pyramid levels: 5e-3 grey levels (fault F1: torch's antialiased bilinear
  filter matches jax.image.resize to ~0.003);
- K1 twin: bit-equal, clamped starts included (it is a copy);
- extract_orb on corridor_seq frames: level 0 works on integer pixels and is
  identical (keypoints, responses, descriptors); at levels >= 1, F1 can flip
  a FAST threshold, so overall agreement is held to >= 99 %;
- the same at the bench's 640x480, 4 levels, 1024 features: descriptors are
  identical wherever the keypoint matches, angles within 2e-5 rad (the
  reference sums the moments in a float32 matmul of its own order; the port
  in float64, rounded once);
- the describe twin against the pre-fusion formula (gather, two einsums,
  float32 matmul orientation) on 8-bit images: angles identical (integer
  moments below 2**24 are exact in any order), descriptor bits in >= 99.9 %
  (the einsums' row pass sums in another order, and a blurred pixel rounded
  to bfloat16 can flip).
"""

from pathlib import Path

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.data.tum import read_pgm
from fitslam_tpu.ops import image as jimage
from fitslam_tpu.ops import orb as jorb
from fitslam_tpu.ops import pallas_patches as jpp
from fitslam_tpu_torch.ops import image as timage
from fitslam_tpu_torch.ops import orb as torb
from fitslam_tpu_torch.ops import pallas_patches as tpp
from fitslam_tpu_torch.utils import interop

# several pytest-xdist workers share the machine: torch's default of one
# intra-op thread per core would oversubscribe it
torch.set_num_threads(2)

SEQ = Path(__file__).parent / "data" / "corridor_seq"


def _frame(i: int) -> np.ndarray:
    return read_pgm(sorted((SEQ / "left").glob("*.pgm"))[i]).astype(np.float32)


@pytest.mark.parametrize("name", ["brief_pattern", "diff_matrix", "blur_matrix", "w_centroid"])
def test_constant_matrices_equal(name):
    ref, got = {
        "brief_pattern": (jorb._make_brief_pattern(), torb._make_brief_pattern()),
        "diff_matrix": (jorb._DIFF_MATRIX, torb._make_rotated_diff_matrix()),
        "blur_matrix": (jorb._BLUR_MATRIX, torb._BLUR_MATRIX),
        "w_centroid": (jorb._W_CENTROID, torb._W_CENTROID),
    }[name]
    assert ref.dtype == got.dtype
    np.testing.assert_array_equal(got, ref)


def test_rotated_pair_gather_equals_diff_matrix_product():
    """The port gathers patch[A] - patch[B] instead of multiplying by the
    reference's difference matrix; the two are equal for bf16-valued patches."""
    rng = np.random.RandomState(0)
    flat = torch.as_tensor(rng.uniform(0, 255, (16, 1024)).astype(np.float32)).bfloat16().float()
    prod = (flat @ torch.as_tensor(torb._make_rotated_diff_matrix())).reshape(16, 30, 256)
    pairs = torch.as_tensor(torb._ROTATED_PAIRS)
    gathered = flat[:, pairs[..., 0]] - flat[:, pairs[..., 1]]
    assert torch.equal(prod, gathered)


@pytest.mark.parametrize("hw", [(480, 640), (240, 320), (100, 150)])
def test_pyramid_shapes(hw):
    for levels, scale in ((4, 1.4142135), (2, 1.2)):
        assert timage.pyramid_shapes(*hw, levels, scale) == jimage.pyramid_shapes(*hw, levels, scale)


def test_pyramid_within_f1_tolerance():
    img = _frame(3)
    ref = jax.jit(lambda x: jimage.build_pyramid(x, 4, 1.4142135))(jnp.asarray(img))
    got = timage.build_pyramid(torch.as_tensor(img), 4, 1.4142135)
    for r, g in zip(ref, got):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-3)


def test_patch_gather_twin_bit_equal_with_clamped_starts():
    rng = np.random.RandomState(5)
    img = rng.uniform(0, 255, (60, 90)).astype(np.float32)
    xy = np.stack([rng.randint(-30, 120, 200), rng.randint(-30, 90, 200)], -1).astype(np.int32)
    ref = np.asarray(jax.jit(lambda a, b: jpp.gather_patches(a, b, 40))(img, xy))
    got = tpp.gather_patches(torch.as_tensor(img), torch.as_tensor(xy), 40)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_patch_gather_wrapper_checks_and_uses_twin_on_cpu():
    before = tpp.gather_patches.launches
    img = torch.zeros((50, 50))
    tpp.gather_patches(img, torch.zeros((3, 2), dtype=torch.int32), 40)
    assert tpp.gather_patches.launches == before     # no kernel launch on a CPU tensor
    with pytest.raises(ValueError):
        tpp.gather_patches(img, torch.zeros((3, 2), dtype=torch.int64), 40)
    with pytest.raises(ValueError):
        tpp.gather_patches(img.double(), torch.zeros((3, 2), dtype=torch.int32), 40)


def test_fast_score_level0_exact():
    img = _frame(0)
    ref = np.asarray(jax.jit(lambda x: jorb.fast_score_map(x, 12.0))(jnp.asarray(img)))
    got = torb.fast_score_map(torch.as_tensor(img), 12.0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_pack_descriptors_matches_reference():
    rng = np.random.RandomState(9)
    desc = np.where(rng.rand(32, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    ref = np.asarray(jorb.pack_descriptors(jnp.asarray(desc, jnp.bfloat16)))
    got = torb.pack_descriptors(torch.as_tensor(desc).bfloat16()).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref)


@pytest.mark.parametrize("frame", [0, 17, 39])
def test_extract_orb_parity(frame):
    img = _frame(frame)
    kw = dict(num_features=512, num_levels=2, fast_threshold=12.0)
    ref = jax.tree.map(np.asarray, jorb.extract_orb(jnp.asarray(img), **kw))
    got = interop.to_numpy(torb.extract_orb(torch.as_tensor(img), **kw))
    ref_desc = np.asarray(ref.desc, np.float32)
    lv0 = ref.level == 0
    np.testing.assert_array_equal(got.level, ref.level)
    np.testing.assert_array_equal(got.valid[lv0], ref.valid[lv0])
    np.testing.assert_array_equal(got.xy[lv0], ref.xy[lv0])
    np.testing.assert_array_equal(got.response[lv0], ref.response[lv0])
    np.testing.assert_array_equal(got.desc[lv0], ref_desc[lv0])
    same = (np.all(np.abs(got.xy - ref.xy) <= 1e-3, axis=1)
            & np.all(got.desc == ref_desc, axis=1) & (got.valid == ref.valid))
    assert same.mean() >= 0.99, same.mean()


@pytest.mark.parametrize("frame", [0, 39])
def test_extract_orb_parity_bench_size(frame):
    """640x480 (a corridor frame upscaled 2x2), 4 levels, 1024 features."""
    img = np.kron(_frame(frame), np.ones((2, 2), np.float32))
    kw = dict(num_features=1024, num_levels=4, fast_threshold=12.0)
    ref = jax.tree.map(np.asarray, jorb.extract_orb(jnp.asarray(img), **kw))
    got = interop.to_numpy(torb.extract_orb(torch.as_tensor(img), **kw))
    ref_desc = np.asarray(ref.desc, np.float32)
    match = (np.all(np.abs(got.xy - ref.xy) <= 1e-3, axis=1) & (got.level == ref.level)
             & (got.valid == ref.valid) & ref.valid)
    assert match.sum() >= 0.99 * ref.valid.sum(), (match.sum(), ref.valid.sum())
    np.testing.assert_array_equal(got.desc[match], ref_desc[match])
    d_ang = np.angle(np.exp(1j * (got.angle[match].astype(np.float64) - ref.angle[match])))
    assert np.abs(d_ang).max() <= 2e-5


def _random_levels(rng, shapes, counts, margin):
    """8-bit level images and keypoints up to ``margin`` pixels past their
    border (windows reach outside the image and are clamped)."""
    levels = [torch.as_tensor(rng.randint(0, 256, s).astype(np.float32)) for s in shapes]
    xy = np.concatenate([
        np.stack([rng.randint(-margin, w + margin, c), rng.randint(-margin, h + margin, c)], -1)
        for (h, w), c in zip(shapes, counts)]).astype(np.int32)
    return levels, torch.as_tensor(xy.reshape(-1, 2))


def _describe_pre_fusion(levels, xy, counts):
    """The describe formula before the fused kernel, as the reference
    computes it: one gather a level, the blur as two einsums against the
    bf16 blur matrix, the moments as a float32 matmul, the bin by scalar
    division."""
    blur = torch.as_tensor(torb._BLUR_MATRIX).bfloat16().float()
    w = torch.as_tensor(torb._W_CENTROID)
    pairs = torch.as_tensor(torb._ROTATED_PAIRS)
    angs, descs = [], []
    for img, p in zip(levels, torch.split(xy, counts)):
        g = tpp.gather_patches_plain(img, p, 40)
        smooth = torch.einsum("npq,qs->nps", g.bfloat16().float(), blur)
        smooth = torch.einsum("nps,pr->nrs", smooth, blur)
        m = g[:, 4:36, 4:36].reshape(g.shape[0], -1) @ w
        ang = torch.atan2(m[:, 1], m[:, 0])
        b = torch.round(ang / (2.0 * math.pi) * 30).long() % 30
        flat = smooth.reshape(-1, 1024).bfloat16().float()
        sel = torch.gather(flat, 1, pairs[b][:, :, 0]) - torch.gather(flat, 1, pairs[b][:, :, 1])
        angs.append(ang)
        descs.append(torch.where(sel < 0, 1.0, -1.0).bfloat16())
    return torch.cat(angs), torch.cat(descs)


@pytest.mark.parametrize("seed", [0, 1])
def test_describe_twin_matches_pre_fusion_formula(seed):
    rng = np.random.RandomState(seed)
    shapes, counts = [(120, 160), (85, 113), (60, 80)], [300, 150, 80]
    levels, xy = _random_levels(rng, shapes, counts, margin=25)
    ref_ang, ref_desc = _describe_pre_fusion(levels, xy, counts)
    ang, desc = torb.describe_keypoints_plain(levels, xy, counts)
    assert ang.dtype == torch.float32 and desc.dtype == torch.bfloat16
    assert torch.equal(ang, ref_ang)
    assert (desc == ref_desc).float().mean().item() >= 0.999


def test_describe_level_table_and_order():
    """Keypoints of all levels in one call, a level with none included, in
    level order: equal to one call a level, concatenated."""
    rng = np.random.RandomState(3)
    shapes, counts = [(90, 130), (64, 92), (45, 65), (40, 46)], [40, 0, 17, 1]
    levels, xy = _random_levels(rng, shapes, counts, margin=20)
    ang, desc = torb.describe_keypoints(levels, xy, counts)
    offsets = np.cumsum([0] + counts)
    for l, img in enumerate(levels):
        part = xy[offsets[l]:offsets[l + 1]]
        a, d = torb.describe_keypoints_plain([img], part, [counts[l]])
        assert torch.equal(ang[offsets[l]:offsets[l + 1]], a)
        assert torch.equal(desc[offsets[l]:offsets[l + 1]], d)
    assert ang.shape == (58,) and desc.shape == (58, 256)


def test_describe_wrapper_checks_and_uses_twin_on_cpu():
    before = torb.describe_keypoints.launches
    img = torch.zeros((50, 60))
    xy = torch.zeros((3, 2), dtype=torch.int32)
    ang, desc = torb.describe_keypoints([img], xy, [3])
    assert torb.describe_keypoints.launches == before     # no kernel launch on a CPU tensor
    assert torch.equal(ang, torch.zeros(3)) and bool((desc == -1).all())
    with pytest.raises(ValueError):
        torb.describe_keypoints([img], xy.long(), [3])
    with pytest.raises(ValueError):
        torb.describe_keypoints([img], xy, [2])           # counts do not add up
    with pytest.raises(ValueError):
        torb.describe_keypoints([img] * 9, xy, [3] + [0] * 8)
    with pytest.raises(ValueError):
        torb.describe_keypoints([img.double()], xy, [3])


def test_blur_taps_rebuild_the_blur_matrix():
    """The twin's 7 taps, laid out as the reference's banded (40, 32) matrix,
    give the matrix back as the reference rounds it (bfloat16)."""
    band = np.zeros((40, 32), np.float32)
    for j in range(32):
        band[j + 1:j + 8, j] = torb._BLUR_TAPS
    ref = torch.as_tensor(jorb._BLUR_MATRIX).bfloat16().float().numpy()
    np.testing.assert_array_equal(band, ref)


def test_orientation_tree_sums_every_pixel():
    """On integer patches every float64 order is exact, so the twin's
    thread-and-warp tree must equal a plain sum of all 1024 weighted pixels."""
    rng = np.random.RandomState(4)
    patches = rng.randint(0, 256, (64, 32, 32)).astype(np.float32)
    m = patches.reshape(64, -1).astype(np.float64) @ jorb._W_CENTROID.astype(np.float64)
    ref = np.arctan2(m[:, 1].astype(np.float32), m[:, 0].astype(np.float32))
    got = torb._orientations(torch.as_tensor(patches)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_angle_bins_divide_truly():
    """round(angle / 2 pi * 30) mod 30 in float32 with a true division, at
    angles spread over the circle and on either side of every bin edge."""
    edges = (np.arange(-15, 16) + 0.5) * (2 * np.pi / 30)
    angle = np.concatenate([np.linspace(-np.pi, np.pi, 4001), edges - 1e-6, edges + 1e-6,
                            np.nextafter(edges.astype(np.float32), 0)]).astype(np.float32)
    q = angle / np.float32(2 * np.pi)
    ref = np.round(q * np.float32(30)).astype(np.int64) % 30
    np.testing.assert_array_equal(torb._angle_bins(torch.as_tensor(angle)).numpy(), ref)
