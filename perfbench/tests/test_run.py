"""run.py refuses to run without the accelerator or the program."""

import os
import shutil
import subprocess
import sys

import pytest

from perfbench import spec

ARGS = ["--workload", "fft1d_c64_n4096.split_rt_b16384", "--seed",
        str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]


def run_in(root):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)


def assert_refused(p):
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_no_gpu_no_result():
    p = run_in(spec.REPO)
    assert_refused(p)
    assert "needs 1 GPU" in p.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".*", "__pycache__"))
    p = run_in(tmp_path)
    assert_refused(p)
    assert "pyfft_tpu" in p.stderr
