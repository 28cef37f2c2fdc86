"""Test config. NOTE: no XLA_FLAGS here — tests must see 1 real device;
sharding tests spawn subprocesses with their own flags."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# Child preamble for mesh_cpu: the device-count flag must be in the
# environment BEFORE jax initializes — XLA_FLAGS is read once at backend
# creation, so a wrong import order silently leaves the child on 1 device.
# The assert makes that failure loud instead: every mesh test is worthless
# if it quietly ran unsharded.
_MESH_SUB = """
import os
flag = "--xla_force_host_platform_device_count={n}"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "").replace(flag, "") + " " + flag).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import json
import jax
if len(jax.devices()) != {n}:
    raise SystemExit(
        "mesh_cpu({n}): child initialized with %d devices, not {n} — "
        "XLA_FLAGS was applied too late (jax imported before the flag was "
        "set?): %r" % (len(jax.devices()), jax.devices()))
import jax.numpy as jnp
import numpy as np
{body}
"""


@pytest.fixture
def mesh_cpu():
    """Runner for multi-device CPU tests: ``mesh_cpu(n, body)`` executes
    ``body`` in a subprocess forced to ``n`` host devices and returns the
    JSON object the body printed on its LAST stdout line.

    Subprocess-safe by construction: the parent session never sets
    XLA_FLAGS (it must keep exactly 1 device), the child sets the flag
    before importing jax, and a loud in-child assert fails the test if the
    device count came out wrong — a mesh test must never silently run on
    1 device. The child inherits the repo environment (PYTHONPATH=src,
    JAX_PLATFORMS=cpu in CI) with the flag appended.
    """
    def run(n: int, body: str, timeout: int = 900) -> dict:
        assert n >= 1, f"mesh_cpu needs a positive device count, got {n}"
        code = _MESH_SUB.format(n=n, body=textwrap.dedent(body))
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # the child sets its own, first thing
        env.setdefault("PYTHONPATH", "src")
        env.setdefault("JAX_PLATFORMS", "cpu")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=timeout,
                             env=env)
        assert out.returncode == 0, (
            f"mesh_cpu({n}) child failed:\n{out.stderr[-4000:]}")
        lines = out.stdout.strip().splitlines()
        assert lines, f"mesh_cpu({n}) child printed nothing"
        return json.loads(lines[-1])

    return run
