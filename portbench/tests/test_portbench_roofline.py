"""K1's operation and byte counts and its bound."""

from portbench.roofline import (HBM_BYTES_PER_S, PEAK_OPS_PER_S, k1_chunk,
                                k1_int8_bound_s, k1_int8_work)


def test_k1_counts_at_the_serving_shape():
    qp, n, d = 2048, 1 << 20, 768
    ops, moved = k1_int8_work(qp, n, d)
    assert ops == 2 * qp * n * d
    # int8 queries and codes, two f32 row factors, int32 keys per 32 rows
    assert moved == qp * d + n * d + 8 * n + qp * (n // 32) * 4
    assert k1_chunk(n) == 4096 and k1_chunk(6144) == 2048
    bound = k1_int8_bound_s(qp, n, d)
    assert bound == ops / PEAK_OPS_PER_S["int8"]
    assert abs(bound * 1e3 - 1.667) < 0.01


def test_k1_few_queries_are_bound_by_bytes():
    qp, n, d = 32, 1 << 20, 768
    ops, moved = k1_int8_work(qp, n, d)
    assert k1_int8_bound_s(qp, n, d) == moved / HBM_BYTES_PER_S
    assert moved / HBM_BYTES_PER_S > ops / PEAK_OPS_PER_S["int8"]
