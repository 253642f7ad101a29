"""The kernels' operations and bytes from shapes, against PERF.md's table."""

import pytest

from harness import roofline


def test_ka_at_a_vith_request():
    b = roofline.ka(16, 4096, 80, 64, 64)
    assert b.flops == pytest.approx(85.9e9, rel=1e-3)
    assert b.bytes == pytest.approx(58.7e6, rel=1e-3)
    assert b.seconds * 1e3 == pytest.approx(0.0869, rel=1e-2)


def test_ke_at_the_vith_train_step():
    b = roofline.ke(32, 4096, 80, 64, 64)
    assert b.flops == pytest.approx(429.5e9, rel=1e-3)
    assert b.bytes == pytest.approx(235.4e6, rel=1e-3)
    assert b.seconds * 1e3 == pytest.approx(0.4343, rel=1e-2)


def test_kb_at_the_vith_encoder():
    b = roofline.kb(1, 21760, 21760, 8, 32, 4, 4)
    assert b.bytes == pytest.approx(55.7e6, rel=1e-3)
    assert b.flops == pytest.approx(0.71e9, rel=1e-2)
    assert b.seconds * 1e3 == pytest.approx(0.0166, rel=1e-2)


def test_kd_at_the_train_encoder():
    b = roofline.kd(2, 21760, 21760, 8, 32, 4, 4)
    assert b.bytes == pytest.approx(200.5e6, rel=1e-3)
    assert b.flops == pytest.approx(2.85e9, rel=1e-2)
    assert b.seconds * 1e3 == pytest.approx(0.0599, rel=1e-2)
