"""Distributed model facade: embeddings + span chain + norm + LM head (the
port of bloombee_tpu/client/model.py `DistributedModelForCausalLM`).

Reference models/*/model.py (Distributed*ForCausalLM) and
RemoteGenerationMixin (client/remote_generation.py:104-402). The client's
math (embedding gather, final RMSNorm, the head's product) is plain
PyTorch on the client's device: the JAX package computes it outside any
Pallas kernel too.

`generate` is the per-step greedy/sampling loop (reference
`_fast_generate_greedy`, remote_generation.py:286-386); passing `session=`
continues a session across calls (:182-216). Token ids go in as int64
tensors or numpy arrays and come out as int64 tensors on the host; hidden
states and logits live on the client's device, which is CUDA unless the
caller asks for the CPU. With `server_decode` (or
`ClientConfig.server_decode`) a greedy generate over a route covering the
whole model asks the servers for chunks of tokens per RPC
(`InferenceSession.decode_n`) after the prefill, and goes on per step on
the same session when they decline.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from bloombee_tpu_torch.client.config import ClientConfig
from bloombee_tpu_torch.client.sequence_manager import RemoteSequenceManager
from bloombee_tpu_torch.client.session import (
    DecodeNUnsupported,
    InferenceSession,
)
from bloombee_tpu_torch.models.checkpoint import load_client_params, load_spec
from bloombee_tpu_torch.models.head import (
    embed_impl,
    norm_head_chunked,
    norm_head_impl,
)
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _ids(x) -> torch.Tensor:
    """Token ids (tensor, numpy array or nested lists) as an int64 tensor
    on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.int64)
    return torch.from_numpy(np.asarray(x, dtype=np.int64))


class DistributedModelForCausalLM:
    """Client-side model: local embed/norm/head + remote block chain."""

    def __init__(
        self,
        spec: ModelSpec,
        client_params: dict,
        manager: RemoteSequenceManager,
        use_push: bool = True,
        config: ClientConfig | None = None,
        device="cuda",
    ):
        self.spec = spec
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in client_params.items()}
        self.manager = manager
        if config is not None:
            # a pre-built manager must still honor the config's routing
            # knobs (from_pretrained applies them at construction)
            manager.update_period = config.update_period
            manager.ban_timeout = config.ban_timeout
            manager.ban_max = config.ban_max
            manager.allowed_servers = (
                set(config.allowed_servers)
                if config.allowed_servers else None
            )
            manager.blocked_servers = set(config.blocked_servers or ())
            manager.load_aware = config.load_aware_routing
            manager.overload_timeout = config.overload_timeout
            manager.overload_max = config.overload_max
            manager.quarantine_timeout = config.quarantine_timeout
            manager.quarantine_max = config.quarantine_max
            manager.integrity_strike_limit = config.integrity_strike_limit
        self.config = config or ClientConfig(use_push=use_push)
        self.use_push = self.config.use_push

    @classmethod
    def from_pretrained(
        cls,
        model_dir: str,
        registry,
        model_uid: str | None = None,
        dtype=None,
        use_push: bool = True,
        config: ClientConfig | None = None,
        device="cuda",
    ) -> "DistributedModelForCausalLM":
        """A client over a local HF model directory (config.json +
        safetensors). There is no hub download: a name that is not a
        directory raises."""
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(
                f"{model_dir!r} is not a local model directory (the port "
                f"reads local checkpoints only)"
            )
        config = config or ClientConfig(use_push=use_push)
        spec = load_spec(model_dir)
        params = load_client_params(model_dir, dtype=dtype, device=device)
        manager = RemoteSequenceManager(
            registry,
            model_uid or model_dir.rstrip("/").split("/")[-1],
            spec.num_hidden_layers,
            update_period=config.update_period,
            ban_timeout=config.ban_timeout,
            ban_max=config.ban_max,
            allowed_servers=config.allowed_servers,
            blocked_servers=config.blocked_servers,
            load_aware=config.load_aware_routing,
            overload_timeout=config.overload_timeout,
            overload_max=config.overload_max,
            quarantine_timeout=config.quarantine_timeout,
            quarantine_max=config.quarantine_max,
            integrity_strike_limit=config.integrity_strike_limit,
        )
        return cls(spec, params, manager, config=config, device=device)

    # ------------------------------------------------------------- components
    def embed(self, input_ids) -> torch.Tensor:
        """Token ids [B, T] -> f32 hidden states [B, T, D] on the device."""
        ids = _ids(input_ids).to(self.device)
        return embed_impl(
            self.params, ids, self.spec.embedding_multiplier,
            "embed_norm" in self.params, self.spec.rms_norm_eps,
        ).float()

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head -> f32 logits, promoted as JAX promotes
        (soft-capped where the spec has a final cap)."""
        hidden = hidden.to(self.device)
        spec = self.spec
        if self.config.use_chunked_head:
            return norm_head_chunked(
                self.params, hidden, spec.rms_norm_eps,
                spec.logits_soft_cap, spec.norm_type,
                step=self.config.chunked_head_step,
            )
        return norm_head_impl(self.params, hidden, spec.rms_norm_eps,
                              spec.logits_soft_cap, spec.norm_type)

    def inference_session(
        self, max_length: int, batch_size: int = 1,
        microbatch: int | str | None = None,
    ) -> InferenceSession:
        cfg = self.config
        cfg.validate()
        return InferenceSession(
            self.manager, max_length, batch_size, use_push=cfg.use_push,
            max_retries=cfg.max_retries, step_timeout=cfg.step_timeout,
            microbatch=(
                microbatch if microbatch is not None else cfg.microbatch
            ),
            embed_fn=self.embed,
            prefix_cache=cfg.prefix_cache,
            repl_every=cfg.kv_repl_every,
            client_id=cfg.client_id,
            overload_retries=cfg.overload_retries,
            resume=cfg.resume,
            resume_timeout=cfg.resume_timeout,
            keepalive_s=cfg.keepalive_s,
            integrity=cfg.integrity,
        )

    # --------------------------------------------------------------- generate
    async def generate(
        self,
        input_ids,  # [B, S] int
        max_new_tokens: int = 20,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        eos_token_id: int | None = None,
        session: InferenceSession | None = None,
        seed: int = 0,
        server_decode: bool | None = None,
    ) -> torch.Tensor:
        """Prompt plus new tokens, [B, S + n] int64 on the host. Sampling
        draws from a torch.Generator seeded by `seed` on the client's
        device: reproducible, but not the same draws as the JAX client's
        numpy generator. `server_decode` (None -> the config's) decodes
        greedy tokens in server-side chunks."""
        self.config.validate()
        input_ids = _ids(input_ids)
        b, s = input_ids.shape
        max_length = s + max_new_tokens
        own_session = session is None
        if own_session:
            session = self.inference_session(max_length, b)
            await session.__aenter__()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        use_sd = (
            self.config.server_decode if server_decode is None
            else server_decode
        )
        try:
            if (
                use_sd
                and not do_sample
                and max_new_tokens > 0
                and session._spans
                and session._spans[0].span.start == 0
                and session._spans[-1].span.end == self.spec.num_hidden_layers
                and (len(session._spans) == 1 or session.use_push)
            ):
                # a declining server is handled inside: per-step decoding
                # goes on on the same session, whose KV holds the prefill
                return await self._generate_server_decode(
                    session, input_ids, max_length, eos_token_id
                )
            out = await session.step(self.embed(input_ids), ids=input_ids)
            ids = input_ids
            finished = torch.zeros((b,), dtype=torch.bool)
            for _ in range(max_new_tokens):
                logits = self.logits(out[:, -1:])[:, 0]  # [B, V]
                next_ids = self._select(
                    logits, do_sample, temperature, top_p, gen
                )
                next_ids, finished = self._mask_finished(
                    next_ids, finished, eos_token_id
                )
                ids = torch.cat([ids, next_ids[:, None]], dim=1)
                if eos_token_id is not None and finished.all():
                    break
                if ids.shape[1] >= max_length:
                    break
                out = await session.step(
                    self.embed(next_ids[:, None]), ids=next_ids[:, None]
                )
            return ids
        finally:
            if own_session:
                await session.__aexit__(None, None, None)

    async def _generate_server_decode(
        self, session, input_ids, max_length, eos_token_id
    ) -> torch.Tensor:
        """Greedy generation with server-side multi-step decode: the
        prefill and the first token as usual, then chunks of
        `server_decode_chunk` tokens per RPC through `session.decode_n`.
        Token-identical to the per-step loop on the same device
        (runtime/decode_loop.py's exactness contract)."""
        b = input_ids.shape[0]

        def chunk_now() -> int:
            # the chunk, clamped to the CURRENT route's advertised
            # decode_n_max (a re-route may land on a server with a smaller
            # bound, which would decline a larger chunk), rounded down to
            # a power of two (the JAX server runs pow2 buckets)
            c = max(1, int(self.config.server_decode_chunk))
            server_max = min(
                (
                    s.span.server_info.decode_n_max
                    for s in session._spans
                    if s.span.server_info.decode_n_max
                ),
                default=None,
            )
            if server_max is not None:
                c = min(c, int(server_max))
            return 1 << (c.bit_length() - 1)

        head_dtype = str(self.params["lm_head"].dtype).removeprefix("torch.")
        out = await session.step(self.embed(input_ids), ids=input_ids)
        finished = torch.zeros((b,), dtype=torch.bool)
        next_ids, finished = self._greedy_next(
            self.logits(out[:, -1:])[:, 0], finished, eos_token_id
        )
        ids = torch.cat([input_ids, next_ids[:, None]], dim=1)
        while ids.shape[1] < max_length and not (
            eos_token_id is not None and finished.all()
        ):
            # a partial chunk rounds DOWN to a power of two as well
            remaining = max_length - ids.shape[1]
            n = min(chunk_now(), 1 << (remaining.bit_length() - 1))
            try:
                toks = torch.from_numpy(await session.decode_n(
                    next_ids.numpy(), n, eos_token_id=eos_token_id,
                    finished=finished.numpy(), head_dtype=head_dtype,
                ))
            except DecodeNUnsupported as e:
                # the server declined (or a recovery re-routed onto a
                # route that cannot chain): go on per step on the SAME
                # session, whose KV holds everything generated so far
                logger.warning(
                    "server-side decode declined (%s); per-step path", e
                )
                return await self._continue_per_step(
                    session, ids, next_ids, finished, max_length,
                    eos_token_id,
                )
            if eos_token_id is not None:
                # cut where the per-step loop would have stopped: the
                # first column after which every row is finished (the
                # server clamps later columns to eos)
                cut = toks.shape[1]
                fin = finished
                for j in range(toks.shape[1]):
                    fin = fin | (toks[:, j] == eos_token_id)
                    if fin.all():
                        cut = j + 1
                        break
                finished = fin
                if cut < toks.shape[1]:
                    # the servers' KV ran past the stop: rewind the
                    # session's record so a REUSED session sees exactly the
                    # per-step path's context (a rebuild and replay on its
                    # next use)
                    session.rewind_decoded_tail(toks.shape[1] - cut)
                toks = toks[:, :cut]
            ids = torch.cat([ids, toks], dim=1)
            next_ids = toks[:, -1]
        return ids

    async def _continue_per_step(
        self, session, ids, next_ids, finished, max_length, eos_token_id
    ) -> torch.Tensor:
        """Per-step continuation from mid-generation state (`ids` holds
        every token so far; `next_ids` is selected but not yet stepped),
        with the main loop's selection."""
        while ids.shape[1] < max_length and not (
            eos_token_id is not None and finished.all()
        ):
            out = await session.step(
                self.embed(next_ids[:, None]), ids=next_ids[:, None]
            )
            next_ids, finished = self._greedy_next(
                self.logits(out[:, -1:])[:, 0], finished, eos_token_id
            )
            ids = torch.cat([ids, next_ids[:, None]], dim=1)
        return ids

    @staticmethod
    def _mask_finished(next_ids, finished, eos_token_id):
        """EOS masking: rows already finished keep emitting eos."""
        if eos_token_id is not None:
            next_ids = torch.where(
                finished, torch.full_like(next_ids, eos_token_id), next_ids
            )
            finished = finished | (next_ids == eos_token_id)
        return next_ids, finished

    @classmethod
    def _greedy_next(cls, logits, finished, eos_token_id):
        return cls._mask_finished(
            logits.argmax(dim=-1).to(device="cpu", dtype=torch.int64),
            finished, eos_token_id,
        )

    @staticmethod
    def _select(logits, do_sample, temperature, top_p, gen):
        """Next ids [B] (int64, host) from logits [B, V]: argmax, or a draw
        from the temperature/top-p distribution with `gen`."""
        if not do_sample:
            return logits.argmax(dim=-1).to(device="cpu", dtype=torch.int64)
        logits = logits / max(temperature, 1e-6)
        probs = torch.softmax(logits, dim=-1)
        if top_p < 1.0:
            # nucleus: zero out the tail outside the top-p mass
            sorted_p, order = probs.sort(dim=-1, descending=True)
            keep_sorted = sorted_p.cumsum(dim=-1) - sorted_p < top_p
            keep = torch.zeros_like(keep_sorted).scatter(
                -1, order, keep_sorted
            )
            probs = torch.where(keep, probs, torch.zeros_like(probs))
            probs = probs / probs.sum(dim=-1, keepdim=True)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            device="cpu", dtype=torch.int64
        )
