"""``Plan(shape, dtype).execute``: the single-device public API."""

from __future__ import annotations

import jax
import numpy as np

from pyfft_tpu import Plan


class PlanTarget:
    def __init__(self, config: dict, traffic, devices):
        if len(devices) != 1:
            raise ValueError("the plan entry runs on one device")
        self.devices = devices
        transform = tuple(config["shape"])
        dtype = np.dtype(config["dtype"])
        self.rank = len(transform)
        self.shape = ((traffic.batch,) if traffic.batch > 1 else ()) \
            + transform
        self.split = traffic.storage == "split"
        self.plan = Plan(transform, dtype)        # sync: wait_for_finish
        real = np.float32 if dtype == np.complex64 else np.float64
        sharding = jax.sharding.SingleDeviceSharding(devices[0])

        def gen(key):
            kr, ki = jax.random.split(key)
            re = jax.random.normal(kr, self.shape, real)
            im = jax.random.normal(ki, self.shape, real)
            return self.from_planes(re, im)

        self.make_input = jax.jit(gen, out_shardings=sharding)
        self._planes = jax.jit(lambda z: (z.real, z.imag))

    def call(self, inverse: bool, arrays):
        out = self.plan.execute(*arrays, inverse=inverse)
        return out if self.split else (out,)

    def planes(self, arrays):
        return tuple(arrays) if self.split else self._planes(arrays[0])

    def from_planes(self, re, im):
        return (re, im) if self.split else (jax.lax.complex(re, im),)


build = PlanTarget
