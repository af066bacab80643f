"""Planted dtype violations on a pricing path: narrow torch dtypes (an
alias among them), a narrow dtype string and a dtype-less torch
constructor."""

import torch


def price(loads, capacity):
    return (loads / capacity).to(torch.float32)  # planted: narrow-float-dtype


def halve(x):
    return x.to(torch.float)  # planted: narrow-float-dtype (alias)


def ids(x):
    return x.to(torch.int)  # planted: narrow-int-dtype (alias)


def shrink(x):
    return x.astype("single")  # planted: narrow-dtype-string


def pad(n):
    return torch.zeros(n)  # planted: implicit-torch-dtype


def wide(n, x):
    return torch.zeros(n, dtype=torch.float64), torch.as_tensor(x)
