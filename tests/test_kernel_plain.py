"""The Triton-route hit-finding kernel (interpret mode) against the numpy
oracle, plain (T, S, 128) input: 4 families x {one, several} channel
blocks x {one window, three chained windows}, with K-slot overflow and
drop counts (tests/kernel_cases.py)."""

import pytest

from tests.kernel_cases import BLOCKS, FAMILIES, WINDOWS, check_case


@pytest.mark.parametrize("windows", sorted(WINDOWS))
@pytest.mark.parametrize("blocks", sorted(BLOCKS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_kernel_matches_oracle_plain(family, blocks, windows):
    check_case(family, blocks, windows, time_packed=False)
