"""The least-bytes counts from shapes."""
import pytest

import roofline

OCEAN = (2400, 3600)
BLOCK = (16, 16)
N = OCEAN[0] * OCEAN[1]
INTERIOR = (OCEAN[0] - 2) * (OCEAN[1] - 2)
BASIN = ((600, 1801), (900, 2703))


@pytest.mark.parametrize("bits", [7, 9, 13])
def test_a_full_field_reads_its_payload_words(bits):
    words = -(-N * bits // 32)
    got = roofline.least_bytes("hszp_nd", "std", OCEAN, bits=bits, block=BLOCK)
    # N * bits is a whole number of words at Ocean size: every payload word
    assert N * bits % 32 == 0
    assert got == 4 * words + 4 + 4       # payload, the anchor, the answer
    blocks = (2400 // 16) * (3600 // 16)
    got = roofline.least_bytes("hszx_nd", "std", OCEAN, bits=bits, block=BLOCK)
    assert got == 4 * words + 4 * blocks + 4


def test_a_stage_one_mean_reads_the_block_means_alone():
    blocks = (2400 // 16) * (3600 // 16)
    assert roofline.least_bytes("hszx_nd", "mean", OCEAN, bits=9,
                                block=BLOCK) == 4 * blocks + 4
    # not over an unaligned window: that takes residuals
    assert roofline.least_bytes("hszx_nd", "mean", OCEAN, bits=9, block=BLOCK,
                                window=BASIN) > 4 * blocks


def test_the_sub_basin_hull_rows():
    """A Lorenzo window statistic depends on the prefix hull: rows 0..1800,
    columns 0..2702; a block-mean one on the window alone."""
    got = roofline.least_bytes("hszp_nd", "mean", OCEAN, bits=8, block=BLOCK,
                               window=BASIN)
    assert got == 1801 * 2703 + 4 + 4
    got = roofline.least_bytes("hszx_nd", "std", OCEAN, bits=8, block=BLOCK,
                               window=BASIN)
    blocks = (1800 // 16 - 600 // 16 + 1) * (2702 // 16 - 900 // 16 + 1)
    assert got == 1201 * 1803 + 4 * blocks + 4


def test_stencils_read_bands_and_write_the_interior():
    bits = 8
    # axis-0 difference: rows 1..2399, columns 0..3598 of the residuals
    d0 = roofline.least_bytes("hszp_nd", "derivative", OCEAN, bits=bits,
                              block=BLOCK, axis=0)
    assert d0 == 2399 * 3599 + 4 + 4 * INTERIOR
    grad = roofline.least_bytes("hszp_nd", "gradient", OCEAN, bits=bits,
                                block=BLOCK)
    union = 2399 * 3599 + 2399 * 3599 - 2398 * 3598
    assert grad == union + 4 + 8 * INTERIOR


def test_a_vector_pair_counts_two_fields():
    for scheme in ("hszp_nd", "hszx_nd"):
        kw = dict(bits=9, block=BLOCK)
        d0 = roofline.least_bytes(scheme, "derivative", OCEAN, axis=0, **kw)
        d1 = roofline.least_bytes(scheme, "derivative", OCEAN, axis=1, **kw)
        out = 4 * INTERIOR
        for op in ("divergence", "curl"):
            got = roofline.least_bytes(scheme, op, OCEAN, **kw)
            assert got == (d0 - out) + (d1 - out) + out


def test_seconds_at_the_datasheet_rate():
    assert roofline.least_seconds(3_350_000_000) == pytest.approx(1e-3)
