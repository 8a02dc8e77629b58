"""The frozen count functions equal chip_smoke.py's on fixed inputs."""
import torch

import chip_smoke
from wgbs_bench import roofline


def test_peaks_and_row_bytes():
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert roofline.CP_ROW_BYTES == chip_smoke.CP_ROW_BYTES
    assert roofline.bound_ms(1e9) == chip_smoke.bound(1e9, 0)["bound_ms"]


def test_pair_join_bytes():
    for args in ((4096, 2, 2, 128), (4096, 4, 4, 128), (64, 2, 4, 256)):
        assert roofline.pair_join_bytes(*args) == \
            chip_smoke.pair_join_bytes(*args)


def test_flat_expand_bytes():
    for B, F, S, shared in ((64, 2, 5, True), (64, 4, 5, False)):
        sp = torch.zeros(B, F, S, dtype=torch.int64)
        starts = (torch.zeros(B, 1, S, dtype=torch.int64).expand(B, F, S)
                  if shared else torch.zeros(B, F, S, dtype=torch.int64))
        lengths = torch.zeros(B, dtype=torch.int64)
        CAP = B * 42
        args = (sp, sp, starts, lengths, (0, 1) * (F // 2), 128, 256, CAP)
        assert roofline.flat_expand_bytes(sp, starts, CAP) == \
            chip_smoke.flat_bytes("flat_expand", args)


def test_fm_locate_bytes():
    """chip_smoke.phase_fm_kernels: rows x 68 B, each live lane its
    2 x 8 + 1 + 4 + 8 bytes, each lane past the fill 8."""
    for lanes, rows, n in ((172_032, 245_076, 97_940), (1000, 0, 2000),
                           (1000, 5000, None)):
        live = lanes if n is None else min(n, lanes)
        want = rows * chip_smoke.CP_ROW_BYTES + live * (2 * 8 + 1 + 4 + 8) \
            + (lanes - live) * 8
        assert roofline.fm_locate_bytes(lanes, rows, n) == want
