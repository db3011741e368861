"""The port imports nothing of JAX or of the JAX package, nor a package the
card's machine lacks, and chip_smoke.py refuses to run without a GPU.

Both checks run in one fresh interpreter (the test process itself has JAX
loaded, for the parity tests): it blocks `jax`, `bloombee_tpu`, `msgpack`,
`ml_dtypes` and `zstandard` in `sys.meta_path` (zstd is optional in the
port's wire, so blocking it must fail no import), imports every module of
the port and chip_smoke.py, then runs chip_smoke's entry point and reports
what it printed."""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import contextlib, importlib, importlib.abc, io, json, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "bloombee_tpu", "msgpack", "ml_dtypes",
           "zstandard")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import bloombee_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    bloombee_tpu_torch.__path__, "bloombee_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
import torch
stdout = io.StringIO()
sys.argv = ["chip_smoke.py"]
with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(io.StringIO()):
    rc = chip_smoke.main()
print(json.dumps({"modules": names, "leaked": leaked, "rc": rc,
                  "stdout": stdout.getvalue(),
                  "cuda": torch.cuda.is_available()}))
"""


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def test_port_imports_with_jax_and_the_jax_package_blocked(probe):
    assert not probe["leaked"]
    for name in (
        "bloombee_tpu_torch.runtime.executor",
        "bloombee_tpu_torch.wire.packer",
        "bloombee_tpu_torch.wire.tensor_codec",
        "bloombee_tpu_torch.wire.rpc",
        "bloombee_tpu_torch.swarm.registry",
        "bloombee_tpu_torch.server.block_server",
        "bloombee_tpu_torch.server.compute_queue",
        "bloombee_tpu_torch.client",
        "bloombee_tpu_torch.client.config",
        "bloombee_tpu_torch.client.integrity",
        "bloombee_tpu_torch.client.model",
        "bloombee_tpu_torch.client.sequence_manager",
        "bloombee_tpu_torch.client.session",
        "bloombee_tpu_torch.swarm.spans",
    ):
        assert name in probe["modules"]
    assert len(probe["modules"]) >= 47  # every module was walked


def test_chip_smoke_fails_without_a_gpu(probe):
    """Without a CUDA device the script exits non-zero and prints nothing
    on stdout (no result line)."""
    if probe["cuda"]:
        pytest.skip("a GPU is present")
    assert probe["rc"] != 0
    assert probe["stdout"] == ""
