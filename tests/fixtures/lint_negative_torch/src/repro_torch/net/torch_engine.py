"""Planted host synchronisations in the device half: ``_run_batch``'s call
closure reads tensors back without counting them."""

import torch

_syncs = 0


def _read_any(mask):
    global _syncs
    _syncs += 1
    return bool(mask.any())  # counted: no finding


def _step(x):
    if x.sum() > 0:  # planted: implicit-host-sync (if on a tensor)
        x = x - 1
    return x, float(x.max())  # planted: implicit-host-sync (float())


def _run_batch(table, device):
    x = torch.from_numpy(table).to(device)
    while _read_any(x > 0):
        x, top = _step(x)
    n = x.sum().item()  # planted: implicit-host-sync (.item())
    return x.cpu().numpy(), n  # planted: implicit-host-sync (.cpu(), .numpy())


def host_only(x):
    return x.sum().item()  # outside the closure: no finding
