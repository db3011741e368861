"""Run the swarm registry (the bootstrap node; the port of
bloombee_tpu/cli/run_registry.py). Usage:

    python -m bloombee_tpu_torch.cli.run_registry --host 0.0.0.0 --port 7700
"""

from __future__ import annotations

import argparse
import asyncio
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7700)
    parser.add_argument("--persist", default=None,
                        help="snapshot records to this file so a restarted "
                        "registry knows the swarm immediately")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.log_level)

    from bloombee_tpu_torch.swarm.registry import RegistryServer

    async def run():
        reg = RegistryServer(host=args.host, port=args.port,
                             persist_path=args.persist)
        await reg.start()
        logging.info("registry listening on %s:%d", args.host, reg.port)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
