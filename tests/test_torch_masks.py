"""The port's polygon rasterization against an independent point-in-polygon
oracle, and against ``eksml_tpu/data/masks.py`` where the reference is
right.

``polygon_fill`` in both packages applies the even-odd rule at pixel
centres.  The reference counts an edge that does not cross a row as a
crossing to the right of every pixel of it, so a polygon with an odd
vertex count comes out inside out.  The port counts only the edges that
cross the row: it is held to the oracle at every vertex count, and to
the reference byte for byte at even counts.
"""

import numpy as np
import pytest

from eksml_tpu.data import masks as j_masks
from eksml_tpu_torch.data import masks as t_masks

H, W = 60, 80
TRIANGLE = [(5.0, 5.0), (32.0, 5.0), (5.0, 17.0)]


def oracle_fill(poly, height, width):
    """Franklin's PNPOLY at every pixel centre, in plain Python."""
    out = np.zeros((height, width), np.uint8)
    n = len(poly)
    for r in range(height):
        y = r + 0.5
        for c in range(width):
            x = c + 0.5
            inside = False
            j = n - 1
            for i in range(n):
                xi, yi = poly[i]
                xj, yj = poly[j]
                if (yi > y) != (yj > y) and \
                        x < (xj - xi) * (y - yi) / (yj - yi) + xi:
                    inside = not inside
                j = i
            out[r, c] = inside
    return out


def star(n, seed):
    """A seeded ``n``-gon around the canvas centre, radii drawn at random
    (not convex for n >= 5), at coordinates no pixel centre lies on."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(8.0, 27.0, n)
    return [(40.0 + float(np.cos(a) * b), 30.0 + float(np.sin(a) * b))
            for a, b in zip(t, r)]


@pytest.mark.parametrize("n", [3, 4, 5, 8])
def test_polygon_fill_equals_the_oracle(n):
    for seed in range(3):
        poly = star(n, seed)
        got = t_masks.polygon_fill(np.asarray(poly), H, W)
        want = oracle_fill(poly, H, W)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        ref = j_masks.polygon_fill(np.asarray(poly), H, W)
        if n % 2 == 0:
            assert got.tobytes() == ref.tobytes()
        else:      # the reference's inside-out fill
            np.testing.assert_array_equal(ref, 1 - want)


def test_the_triangle_fills_its_inside():
    got = t_masks.polygon_fill(np.asarray(TRIANGLE), H, W)
    want = oracle_fill(TRIANGLE, H, W)
    np.testing.assert_array_equal(got, want)
    assert 0 < int(got.sum()) < 27 * 12
    # the reference fills 4638 of the 4800 pixels
    assert int(j_masks.polygon_fill(np.asarray(TRIANGLE), H, W).sum()) \
        == H * W - int(want.sum()) == 4638
    # the crop the loader takes: an odd polygon's box mask is its inside
    x1, y1, x2, y2 = 4.0, 4.0, 33.0, 18.0
    flat = [v for p in TRIANGLE for v in p]
    crop = t_masks.polygons_to_bbox_mask([flat], (x1, y1, x2, y2), 28)
    scaled = [((x - x1) / (x2 - x1) * 28, (y - y1) / (y2 - y1) * 28)
              for x, y in TRIANGLE]
    np.testing.assert_array_equal(crop, oracle_fill(scaled, 28, 28))
