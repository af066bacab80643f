"""Planted determinism violations: one per code of the port's checker."""

import os
import random
import time
import uuid

import numpy as np
import torch


def sample_capacities(n):
    rng = np.random.default_rng()  # planted: unseeded-default-rng
    return rng.random(n)


def legacy(n):
    return np.random.rand(n)  # planted: global-numpy-rng


def stdlib(xs):
    return random.choice(xs)  # planted: stdlib-random


def ctor():
    return random.Random()  # planted: unseeded-random-ctor


def impure():
    return np.random.default_rng(time.time_ns())  # planted: impure-prng-seed + time-read


def env():
    return os.getenv("SEED")  # planted: env-read


def entropy():
    return uuid.uuid4()  # planted: os-entropy


def order(xs):
    return [x for x in set(xs)]  # planted: set-iteration-order


def draws(n):
    torch.manual_seed(0)  # planted: global-torch-rng
    return torch.rand(n)  # planted: global-torch-rng


def generator(device):
    return torch.Generator(device=device)  # planted: unseeded-torch-generator


def seeded(device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(4, generator=gen)
