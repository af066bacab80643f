"""Names the fast path only (the planted parity-test-lacks-symbol)."""

from repro_torch.net.bad_parity import planted_fast


def check_fast():
    assert planted_fast([2, 1]) == [1, 2]
