"""Planted parity violations: a reference with no manifest entry, and
registered ones whose tests are missing or never name them."""


def _planted_reference(x):  # planted: unregistered-reference
    return sorted(x)


def _untested_reference(x):
    return sorted(x)


def _absent_test_reference(x):
    return sorted(x)


def planted_fast(x):
    return sorted(x)
