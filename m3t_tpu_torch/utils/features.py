"""Native DAISY and FREAK descriptors for the texture modality (a copy of
m3t_tpu/utils/features.py: numpy, with cv2 imported inside the functions that blur and
filter).

The reference supports ORB / BRISK / DAISY / FREAK / SIFT descriptors
(M3T/include/m3t/texture_modality.h:77-88, src/texture_modality.cpp:739-801); DAISY and
FREAK live in OpenCV's contrib module ``cv2.xfeatures2d``, which is not available in
every OpenCV build (including this one).  This module provides self-contained numpy
implementations with the same constructor parameters and the ``compute(image,
keypoints) -> (keypoints, descriptors)`` calling convention, so TextureModality can
offer the full descriptor menu everywhere.  They follow the published algorithms:

* DAISY (Tola et al., PAMI 2010): per-keypoint grid of Gaussian-pooled gradient
  orientation histograms — q_hist orientation maps convolved per ring level, sampled
  at 1 + q_radius * q_theta locations; descriptor length (q_radius*q_theta+1)*q_hist
  (200 floats for the default 15/3/8/8), matched with L2 like the reference
  (texture_modality.cpp:794-797).
* FREAK (Alahi et al., CVPR 2012): a 43-point retinal sampling pattern over
  ``n_octaves`` size octaves, optional orientation normalization from the 45
  symmetric long pairs, and a 512-bit binary descriptor from coarse-to-fine smoothed
  intensity comparisons (OpenCV learns the pair selection from data; here the pairs
  are chosen deterministically coarse-to-fine, which preserves the descriptor's
  structure and Hamming matching semantics).
"""

from __future__ import annotations

import numpy as np


def _gaussian_blur(image: np.ndarray, sigma: float) -> np.ndarray:
    import cv2

    if sigma <= 0:
        return image
    return cv2.GaussianBlur(image, (0, 0), sigmaX=float(sigma), sigmaY=float(sigma))


class DaisyDescriptor:
    """DAISY descriptor at given keypoints (cv2.xfeatures2d.DAISY compatible subset).

    Parameters mirror the reference's daisy_* settings
    (texture_modality.h:77-81): radius of the outer ring, number of rings
    (q_radius), samples per ring (q_theta), orientation bins (q_hist).
    """

    def __init__(self, radius: float = 15.0, q_radius: int = 3, q_theta: int = 8,
                 q_hist: int = 8):
        self.radius = float(radius)
        self.q_radius = int(q_radius)
        self.q_theta = int(q_theta)
        self.q_hist = int(q_hist)

    @property
    def descriptor_size(self) -> int:
        return (self.q_radius * self.q_theta + 1) * self.q_hist

    def compute(self, image: np.ndarray, keypoints):
        import cv2

        if not keypoints:
            return keypoints, None
        gray = image if image.ndim == 2 else cv2.cvtColor(image,
                                                          cv2.COLOR_BGR2GRAY)
        g = gray.astype(np.float32)
        gx = cv2.Sobel(g, cv2.CV_32F, 1, 0, ksize=3)
        gy = cv2.Sobel(g, cv2.CV_32F, 0, 1, ksize=3)

        # Orientation maps: relu of the gradient projected on q_hist directions.
        angles = 2.0 * np.pi * np.arange(self.q_hist) / self.q_hist
        maps = [np.maximum(gx * np.cos(a) + gy * np.sin(a), 0.0) for a in angles]

        # Ring radii and pooling sigmas (Tola et al. section 3.2: sigma = R(r)/2).
        ring_radii = [self.radius * (r + 1) / self.q_radius
                      for r in range(self.q_radius)]
        sigmas = [self.radius / (2.0 * self.q_radius)] + [
            rr / 2.0 for rr in ring_radii]
        blurred = []  # per pooling level: list of q_hist maps
        for s in sigmas:
            blurred.append([_gaussian_blur(m, s) for m in maps])

        h, w = g.shape
        pts = np.asarray([kp.pt for kp in keypoints], np.float32)
        descriptors = np.zeros((len(pts), self.descriptor_size), np.float32)

        def hist_at(level: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
            ui = np.clip(np.round(u).astype(np.int64), 0, w - 1)
            vi = np.clip(np.round(v).astype(np.int64), 0, h - 1)
            out = np.stack([blurred[level][k][vi, ui]
                            for k in range(self.q_hist)], axis=-1)
            norm = np.linalg.norm(out, axis=-1, keepdims=True)
            return out / np.maximum(norm, 1e-12)

        col = 0
        descriptors[:, col:col + self.q_hist] = hist_at(0, pts[:, 0], pts[:, 1])
        col += self.q_hist
        for r, rr in enumerate(ring_radii):
            for t in range(self.q_theta):
                a = 2.0 * np.pi * t / self.q_theta
                u = pts[:, 0] + rr * np.cos(a)
                v = pts[:, 1] + rr * np.sin(a)
                descriptors[:, col:col + self.q_hist] = hist_at(r + 1, u, v)
                col += self.q_hist
        return keypoints, descriptors


def _freak_pattern(pattern_scale: float):
    """The 43-point retinal layout (FREAK paper fig. 4): center + 7 rings of 6,
    radii and pooling sigmas decreasing exponentially toward the fovea."""
    points = [(0.0, 0.0, 0.1)]
    n_rings = 7
    for ring in range(n_rings):
        # outermost ring index 0; radius shrinks by ~0.7 per ring
        radius = pattern_scale * (0.7 ** ring)
        sigma = 0.5 * radius * (2 ** 0.5) / 2.0
        phase = (np.pi / 6.0) * (ring % 2)
        for k in range(6):
            a = phase + 2.0 * np.pi * k / 6.0
            points.append((radius * np.cos(a), radius * np.sin(a),
                           max(sigma, 0.1)))
    return np.asarray(points, np.float32)  # (43, 3): x, y, sigma


class FreakDescriptor:
    """FREAK binary descriptor (cv2.xfeatures2d.FREAK compatible subset).

    Parameters mirror the reference's freak_* settings (texture_modality.h:82-88).
    Descriptors are 64 bytes (512 bits), matched with Hamming distance.
    """

    N_PAIRS = 512

    def __init__(self, orientation_normalized: bool = True,
                 scale_normalized: bool = True, pattern_scale: float = 22.0,
                 n_octaves: int = 4):
        self.orientation_normalized = bool(orientation_normalized)
        self.scale_normalized = bool(scale_normalized)
        self.pattern_scale = float(pattern_scale)
        self.n_octaves = int(n_octaves)
        base = _freak_pattern(self.pattern_scale)
        # Deterministic coarse-to-fine pair selection: sort all 903 pairs by the
        # summed pooling sigma (largest receptive fields first, like the paper's
        # learned ordering) and keep the first 512.
        n = len(base)
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        pairs.sort(key=lambda ij: -(base[ij[0], 2] + base[ij[1], 2]))
        self._pairs = np.asarray(pairs[: self.N_PAIRS], np.int64)
        self._base = base
        # 45 symmetric long pairs for orientation (paper section 4.2): the pairs
        # with the largest point separation.
        opairs = sorted(
            pairs,
            key=lambda ij: -np.hypot(base[ij[0], 0] - base[ij[1], 0],
                                     base[ij[0], 1] - base[ij[1], 1]))
        self._orientation_pairs = np.asarray(opairs[:45], np.int64)

    def compute(self, image: np.ndarray, keypoints):
        import cv2

        if not keypoints:
            return keypoints, None
        gray = image if image.ndim == 2 else cv2.cvtColor(image,
                                                          cv2.COLOR_BGR2GRAY)
        g = gray.astype(np.float32)
        h, w = g.shape

        # Pooled intensities via a small Gaussian pyramid of blurs shared across
        # keypoints; each pattern point samples the blur closest to its sigma.
        base = self._base
        kp_size = np.asarray([kp.size if kp.size > 0 else 7.0
                              for kp in keypoints], np.float32)
        scale = (kp_size / 7.0 if self.scale_normalized
                 else np.ones_like(kp_size))
        sigma_levels = np.geomspace(max(base[:, 2].min(), 0.5),
                                    base[:, 2].max() * scale.max() + 1e-3, 6)
        pyramid = [_gaussian_blur(g, s) for s in sigma_levels]

        def sample(u, v, sigma):
            shape = np.broadcast_shapes(u.shape, v.shape, sigma.shape)
            uf = np.broadcast_to(u, shape).reshape(-1)
            vf = np.broadcast_to(v, shape).reshape(-1)
            sf = np.broadcast_to(sigma, shape).reshape(-1)
            level = np.argmin(np.abs(sigma_levels[None, :] - sf[:, None]), axis=1)
            ui = np.clip(np.round(uf).astype(np.int64), 0, w - 1)
            vi = np.clip(np.round(vf).astype(np.int64), 0, h - 1)
            out = np.empty(uf.shape, np.float32)
            for lev in range(len(sigma_levels)):
                m = level == lev
                if m.any():
                    out[m] = pyramid[lev][vi[m], ui[m]]
            return out.reshape(shape)

        pts = np.asarray([kp.pt for kp in keypoints], np.float32)  # (K, 2)
        px = base[None, :, 0] * scale[:, None]  # (K, 43)
        py = base[None, :, 1] * scale[:, None]
        ps = base[None, :, 2] * scale[:, None]

        if self.orientation_normalized:
            i0 = sample(pts[:, 0:1] + px, pts[:, 1:2] + py, ps)
            op = self._orientation_pairs
            dx = px[:, op[:, 0]] - px[:, op[:, 1]]
            dy = py[:, op[:, 0]] - py[:, op[:, 1]]
            norm = np.maximum(np.hypot(dx, dy), 1e-9)
            di = i0[:, op[:, 0]] - i0[:, op[:, 1]]
            ox = np.sum(di * dx / norm, axis=1)
            oy = np.sum(di * dy / norm, axis=1)
            angle = np.arctan2(oy, ox)
            ca, sa = np.cos(angle)[:, None], np.sin(angle)[:, None]
            px, py = px * ca - py * sa, px * sa + py * ca

        intensities = sample(pts[:, 0:1] + px, pts[:, 1:2] + py, ps)
        pr = self._pairs
        bits = (intensities[:, pr[:, 0]]
                > intensities[:, pr[:, 1]]).astype(np.uint8)  # (K, 512)
        return keypoints, np.packbits(bits, axis=1)
