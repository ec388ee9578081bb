"""work.py's count of an update against a hand count at a small shape."""
import numpy as np

from benchmark import work


def test_update_bytes_by_hand():
    # one barcode, 204,800 sites (2,048 rows), 11 buckets, 100 read-start
    # windows, a batch of 1,000 bytes that changes 300 coverage entries
    G, Gd = 204_800, 2_048
    by_hand = (
        10 * G          # coverage, 5 uint16 planes, read
        + G             # zeroed, read
        + 11            # bucket switches, read
        + 8 * 100       # read starts, 2 float32 a window, read
        + 2 * Gd        # strategy, 2 strands, read
        + 2 * G         # reference symbol and site validity
        + 25 * Gd       # the six int32 row tables and the row validity
        + 1_000         # the batch
        + 2 * 300       # changed coverage entries, written
        + 2 * Gd + 11 + 8 * 100  # strategy, switches and read starts, written
    )
    assert work.update_bytes(G, 1, Gd, 11, 100, 1_000, 300) == by_hand


def test_score_ops_and_least_time():
    flops, sfu = work.score_ops(1_000, 5, 15)
    assert flops == 2 * (2 * 5 * 15 + 15 + 5) * 1_000
    assert sfu == (15 + 5 + 2) * 1_000
    t, by = work.least_time_s(3_350_000_000, 0, 0)
    assert by == "bytes" and abs(t - 1e-3) < 1e-12
    t, by = work.least_time_s(0, 0, int(work.SFU_PER_S))
    assert by == "special functions" and abs(t - 1.0) < 1e-12


def test_batch_bytes_pads_each_field_to_four():
    b = {"a": np.zeros(3, np.uint8), "b": np.zeros(2, np.uint16), "c": np.zeros(5, np.int32)}
    assert work.batch_bytes(b) == 4 + 4 + 20
