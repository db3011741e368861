"""Entry points of the port (the counterparts of bloombee_tpu/cli/):

    python -m bloombee_tpu_torch.cli.run_registry --port 7700
    python -m bloombee_tpu_torch.cli.run_server MODEL_DIR --blocks 0:16 \\
        --registry 127.0.0.1:7700
    python -m bloombee_tpu_torch.cli.health MODEL_UID --num-blocks 32 \\
        --registry 127.0.0.1:7700 --probe

Each span runs in its own process; the servers run on the card unless
`--device cpu` asks for the host.
"""
