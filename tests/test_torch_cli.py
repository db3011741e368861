"""The port's entry points on the CPU (the analogs of tests/test_cli_e2e.py
and of the JAX CLI's flags), and the server's drain default.

- subprocesses: `python -m bloombee_tpu_torch.cli.run_registry` and
  `...cli.run_server --device cpu` over a locally saved tiny Llama; the
  port client (per step and with server_decode) and the JAX client give
  HF's greedy tokens, `cli.health --probe` lists the span ONLINE and the
  swarm COMPLETE, and SIGTERM drains the server, which exits 0;
- `run_server` refuses every flag the port lacks, named with its ROADMAP
  item, and only when set away from the JAX default;
- `env.describe()` lists every switch the port declares, in the JAX
  table's format;
- `BlockServer.drain()` waits `drain_timeout` (30 s of clock time by
  default, under a 20x clock) for an idle session, and an explicit
  `drain(timeout=5)` wins.

Every networked test bounds itself (at most 60 s), and the subprocesses
are killed in a `finally`.
"""

import asyncio
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bloombee_tpu.client.model import (
    DistributedModelForCausalLM as JaxModel,
)
from bloombee_tpu.swarm import registry as j_registry
from bloombee_tpu.utils import env as j_env
from bloombee_tpu_torch.cli import run_server
from bloombee_tpu_torch.client import ClientConfig, DistributedModelForCausalLM
from bloombee_tpu_torch.swarm.registry import RegistryClient
from bloombee_tpu_torch.utils import clock, env
from bloombee_tpu_torch.utils.clock import ScaledClock
from bloombee_tpu_torch.wire import rpc as t_rpc
from test_torch_server import (  # noqa: F401  (fixtures)
    hf_greedy,
    loop,
    port_server,
    registry,
    tiny_model_dir,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
LIMIT = 60  # seconds: every networked test fails instead of stalling


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(module: str, args: list[str], log_path, home) -> subprocess.Popen:
    # log to a file, not a pipe: an undrained pipe blocks a chatty child
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"bloombee_tpu_torch.cli.{module}", *args],
        stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
        # the throughput cache lives under HOME: keep it in the test's dir
        env={**os.environ, "HOME": str(home)},
    )
    proc.log_path = log_path
    return proc


def logs(procs) -> str:
    return "\n".join(
        f"--- {p.log_path} ---\n" + open(p.log_path).read()[-3000:]
        for p in procs
    )


def wait_port(port: int, procs, timeout_s: float = 30.0) -> None:
    """Until the registry accepts connections (a server announces at
    start, and fails if nothing listens)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        assert all(p.poll() is None for p in procs), logs(procs)
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"port {port} never came up\n" + logs(procs))


async def wait_complete(reg_port, uid, n_blocks, procs, timeout_s=45.0):
    reader = RegistryClient("127.0.0.1", reg_port)
    deadline = time.monotonic() + timeout_s
    try:
        while time.monotonic() < deadline:
            for p in procs:
                assert p.poll() is None, logs(procs)
            try:
                infos = await reader.get_module_infos(uid, range(n_blocks))
                if all(mi.servers for mi in infos):
                    return
            except (OSError, t_rpc.RpcError):
                pass  # the registry is still starting
            await asyncio.sleep(0.2)
        raise TimeoutError("the swarm never became complete\n" + logs(procs))
    finally:
        await reader.close()


def test_cli_registry_server_clients_health_sigterm(tiny_model_dir,
                                                     tmp_path):
    model_dir, hf_model, config = tiny_model_dir
    reg_port = free_port()
    registry_proc = spawn(
        "run_registry", ["--host", "127.0.0.1", "--port", str(reg_port)],
        tmp_path / "registry.log", tmp_path,
    )
    procs = [registry_proc]
    try:
        wait_port(reg_port, procs)
    except BaseException:
        registry_proc.kill()
        registry_proc.wait()
        raise
    server_proc = spawn(
        "run_server",
        [model_dir, "--model-uid", "tiny-cli", "--registry",
         f"127.0.0.1:{reg_port}", "--blocks", "0:3", "--host", "127.0.0.1",
         "--public-host", "127.0.0.1", "--num-pages", "64", "--page-size",
         "4", "--dtype", "float32", "--device", "cpu", "--drain-timeout",
         "5", "--warmup-batches", "1,2"],
        tmp_path / "server.log", tmp_path,
    )
    procs.append(server_proc)
    x = np.random.default_rng(0).integers(0, config.vocab_size, (2, 6))
    try:
        asyncio.run(asyncio.wait_for(
            wait_complete(reg_port, "tiny-cli", 3, procs), LIMIT
        ))

        async def clients():
            rc = RegistryClient("127.0.0.1", reg_port)
            jrc = j_registry.RegistryClient("127.0.0.1", reg_port)
            try:
                port = DistributedModelForCausalLM.from_pretrained(
                    model_dir, rc, model_uid="tiny-cli", device="cpu",
                    config=ClientConfig(server_decode_chunk=4),
                )
                per_step = await port.generate(x, max_new_tokens=8)
                chunked = await port.generate(x, max_new_tokens=8,
                                              server_decode=True)
                jax_model = JaxModel.from_pretrained(
                    model_dir, jrc, model_uid="tiny-cli"
                )
                jax_ids = await jax_model.generate(x, max_new_tokens=8)
                return per_step, chunked, jax_ids
            finally:
                await rc.close()
                await jrc.close()

        per_step, chunked, jax_ids = asyncio.run(
            asyncio.wait_for(clients(), LIMIT)
        )
        want = hf_greedy(hf_model, x, 8)
        np.testing.assert_array_equal(per_step.numpy(), want)
        np.testing.assert_array_equal(chunked.numpy(), want)
        np.testing.assert_array_equal(np.asarray(jax_ids), want)

        probe = subprocess.run(
            [sys.executable, "-m", "bloombee_tpu_torch.cli.health",
             "tiny-cli", "--num-blocks", "3", "--registry",
             f"127.0.0.1:{reg_port}", "--probe"],
            capture_output=True, text=True, timeout=LIMIT, cwd=REPO,
        )
        out = probe.stdout
        assert probe.returncode == 0, out + probe.stderr
        assert "COMPLETE" in out and "[reachable]" in out, out
        span = [ln for ln in out.splitlines() if "blocks [0:3)" in ln]
        assert len(span) == 1 and "ONLINE" in span[0], out
        assert "decode_n_calls=" in span[0] and "tx_wire_bytes=" in span[0]
        assert "decode_n_max=256" in span[0]

        t0 = time.monotonic()
        server_proc.send_signal(signal.SIGTERM)
        assert server_proc.wait(timeout=5 + 10) == 0, logs(procs)
        assert time.monotonic() - t0 < 15
        assert "received SIGTERM: draining" in open(server_proc.log_path).read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("flags,item", [
    (["--adapters", "a=/x"], "16"),
    (["--adapter-dirs", "/x"], "16"),
    (["--offload-layers", "2"], "16"),
    (["--attn-sparsity", "0.5"], "16"),
    (["--weight-quant", "int8"], "14"),
    (["--tp", "2"], "18"),
    (["--sp", "2"], "18"),
    (["--oversubscribe", "2"], "12b"),
    (["--idle-park-s", "1"], "12b"),
    (["--admit"], "19"),
    (["--admit-high-ms", "50"], "19"),
    (["--standby"], "19"),
    (["--promote-high-ms", "9"], "19"),
    (["--promote-low-ms", "9"], "19"),
    (["--promote-sustain-s", "9"], "19"),
    (["--promote-jitter-s", "9"], "19"),
    (["--rebalance-period", "300"], "19"),
    (["--artifact-dir", "/x"], "19"),
    (["--load-advert-s", "1"], "19"),
    (["--num-blocks", "2"], "19"),
    (["--blocks", None], "19"),  # no --blocks at all
    (["--registry", "127.0.0.1:1,127.0.0.1:2"], "19"),
], ids=lambda v: v if isinstance(v, str) else str(v[0]).lstrip("-"))
def test_run_server_refuses_unported_flags(capsys, flags, item):
    argv = ["/no/such/model"]
    if flags[-1] is not None:
        argv += flags
    if "--blocks" not in flags:
        argv += ["--blocks", "0:1"]
    with pytest.raises(SystemExit) as err:
        run_server.main(argv)
    assert err.value.code == 2
    msg = capsys.readouterr().err
    name = flags[0].lstrip("-")
    assert name in msg and f"ROADMAP Queue 1 item {item}" in msg, msg


def test_run_server_defaults_are_not_refused():
    """A JAX deployment's command line with the refusable flags at their
    defaults (or spelled out as such) passes the check; only the model
    directory is then missing."""
    args = run_server.parser().parse_args(
        ["/m", "--blocks", "0:1", "--weight-quant", "none",
         "--rebalance-period", "0", "--tp", "1", "--attn-sparsity", "1.0"]
    )
    assert run_server._unported(args) is None
    with pytest.raises(SystemExit):
        run_server.main(["/no/such/model", "--blocks", "0:1"])


def test_run_server_on_cuda_without_a_gpu_raises(tiny_model_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_server.main([tiny_model_dir[0], "--blocks", "0:1",
                         "--warmup-batches", "", "--device", "cuda"])


# ------------------------------------------------------------ switches
def test_env_describe_lists_every_declared_switch():
    env.import_declaring_modules()
    table = env.describe()
    declared = set()
    for path in (REPO / "bloombee_tpu_torch").rglob("*.py"):
        declared |= set(re.findall(r'declare\(\s*"(BBTPU_\w+)"',
                                   path.read_text()))
    assert declared and declared == set(env._REGISTRY)
    lines = table.splitlines()
    # the JAX table's header and row format
    assert lines[:2] == j_env.describe().splitlines()[:2]
    names = [ln.split(" | ")[0].removeprefix("| ") for ln in lines[2:]]
    assert names == sorted(declared)
    flag = env._REGISTRY["BBTPU_PAGED_MIN_CONTEXT"]
    assert (f"| BBTPU_PAGED_MIN_CONTEXT | int | 512 | {flag.help} |"
            in lines)


def test_health_switches_prints_the_table():
    out = subprocess.run(
        [sys.executable, "-m", "bloombee_tpu_torch.cli.health",
         "--switches"],
        capture_output=True, text=True, timeout=LIMIT, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert "| BBTPU_SESSION_LEASE_S | float |" in out.stdout


# ------------------------------------------------------------ drain
@pytest.mark.parametrize("timeout,want_s", [(None, 30.0), (5.0, 5.0)],
                         ids=["default", "explicit"])
def test_drain_waits_drain_timeout_for_an_idle_session(
    loop, tiny_model_dir, registry, timeout, want_s
):
    """One idle session stays open: drain() stops the server after its
    drain_timeout (30 s by default, not the 60 s it used to wait) of
    clock time, or after an explicit timeout. A 20x clock, installed
    before the server is built, keeps it at 1.5 s of real time."""
    model_dir = tiny_model_dir[0]

    async def go():
        prev = clock.install(ScaledClock(scale=20.0))
        server = port_server(model_dir, registry.port, "drain-default",
                             0, 3)
        try:
            assert server.drain_timeout == 30.0
            await server.start()
            conn = await t_rpc.connect("127.0.0.1", server.port)
            try:
                await conn.open_stream("rpc_inference", {
                    "session_id": "idle", "batch_size": 1, "max_length": 8,
                })
                while "idle" not in server._sessions:
                    await asyncio.sleep(0.01)
                t0 = clock.monotonic()
                await server.drain(timeout=timeout)
                return clock.monotonic() - t0
            finally:
                await conn.close()
        finally:
            await server.registry.close()
            clock.install(prev)

    waited = asyncio.run_coroutine_threadsafe(go(), loop).result(LIMIT)
    assert want_s <= waited < want_s + 5.0, waited
