"""``pyfft_tpu.parallel.make_dist_fft{,2,3}``: one transform over a mesh of
chips, the first transform axis sharded over ``sp`` and the batch over
``dp``; planar (re, im) arrays in and out."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyfft_tpu.parallel import make_dist_fft, make_dist_fft2, make_dist_fft3


class DistTarget:
    def __init__(self, config: dict, traffic, devices):
        if traffic.storage != "split":
            raise ValueError("the dist entry takes split (planar) data")
        mesh_shape = (config["mesh"]["dp"], config["mesh"]["sp"])
        if mesh_shape[0] * mesh_shape[1] != len(devices):
            raise ValueError(f"mesh {mesh_shape} needs {np.prod(mesh_shape)} "
                             f"devices, the cell has {len(devices)}")
        self.devices = devices
        transform = tuple(config["shape"])
        self.rank = len(transform)
        self.shape = (traffic.batch,) + transform
        mesh = Mesh(np.array(devices).reshape(mesh_shape), ("dp", "sp"))
        make = {1: make_dist_fft, 2: make_dist_fft2, 3: make_dist_fft3}[
            self.rank]
        arg = transform[0] if self.rank == 1 else transform
        self._fwd = make(mesh, arg, sign=-1)
        self._inv = make(mesh, arg, sign=+1, normalize=True)
        self.sharding = NamedSharding(
            mesh, P("dp", "sp", *([None] * (self.rank - 1))))
        real = np.float32 if np.dtype(config["dtype"]) == np.complex64 \
            else np.float64

        def gen(key):
            kr, ki = jax.random.split(key)
            return (jax.random.normal(kr, self.shape, real),
                    jax.random.normal(ki, self.shape, real))

        self.make_input = jax.jit(gen, out_shardings=(self.sharding,) * 2)

    def call(self, inverse: bool, arrays):
        return (self._inv if inverse else self._fwd)(*arrays)

    def planes(self, arrays):
        return tuple(arrays)

    def from_planes(self, re, im):
        return re, im


build = DistTarget
