"""The model facade over the ten archs of ``configs/``: the dense GQA
family (internlm2-1.8b, glm4-9b, mistral-nemo-12b), MLA (minicpm3-4b), the
MoE family (deepseek-moe-16b, dbrx-132b), the hybrid family (hymba-1.5b),
the xLSTM family (xlstm-350m), the VLM (llama-3.2-vision-11b) and the
audio encoder-decoder (whisper-base); the port of
``src/repro/models/model.py``.

`Model` is an ``nn.Module`` whose parameters keep the reference's tree and
shapes (``embed``, ``norm_f``, ``unembed``, ``meta``, then ``blocks/...``
stacked on ``[L, ...]``, or ``m_blocks`` / ``s_blocks`` stacked on the
xLSTM's ``[P, ...]`` pairs; the VLM's ``blocks`` of its self layers,
``cross`` of its cross-attention blocks and ``vision_proj``; the audio
model's ``enc`` and ``dec``, each ``blocks`` and ``ln_f``) in the config's
``param_dtype``, so one ``state_dict`` serves the reference's params, the
checkpoint service and the training slice.  Methods:

* ``init(generator)`` — fill the parameters from a ``torch.Generator``.
* ``loss(batch, params=None)`` — the causal-LM loss, with autograd, for
  every family (hybrid: its meta tokens prepended; VLM and audio: the
  batch's ``frontend``), with chunked CE (the ``[B, T, V]`` logits are
  never materialised); ``params`` defaults to the model's own.  No kernel
  of the port runs in it: each family's mixers take their train forms.
* ``release()`` / ``materialise(device)`` / ``adopt(params)`` — drop every
  parameter's storage (meta tensors), allocate it again, or take a tree
  of tensors (a restored checkpoint) as the parameters without a copy:
  the hooks a preemptible training job needs.
* ``prefill(batch, cache)`` — populate the cache, return last logits.
  The VLM's and the audio model's batch carries ``frontend``: vision
  patch embeddings [B, n_patches, vision_dim] (projected by
  ``vision_proj``) or audio frame embeddings [B, n_audio_ctx, d_model]
  (the encoder's input); decode reads what the prefill cached.
* ``decode_step(cache, tokens)`` — one serve step.
* ``init_cache(batch, max_seq, dtype)`` — the reference's cache layout:
  ``length`` [] int32; for the attention families ``pos`` [B, S] int32 and
  ``layers.k``, ``layers.v`` [L, B, S, KVH, D] (MLA instead
  ``layers.ckv`` [L, B, S, r_kv] and ``layers.kr`` [L, B, S, d_rope]; the
  VLM over its self layers only), plus for the hybrid family
  ``layers.ssm_h`` [L, B, d_inner, d_state] fp32 and ``layers.ssm_conv``
  [L, B, d_conv - 1, d_inner], for the VLM ``layers.xk``, ``layers.xv``
  [n_groups, B, n_patches, KVH, D] and for the audio model ``layers.xk``,
  ``layers.xv`` [L, B, n_audio_ctx, KVH, D]; for the xLSTM family
  ``layers`` is an `models.xlstm.XLSTMStackState` and there is no ``pos``.

Weights are cast to the compute dtype at each use, as the reference does
(a bf16 serving copy is later performance work).  ``prefill`` and
``decode_step`` write the cache's tensors **in place** and return a new
dict over them with the new ``length``.  Every xLSTM prefill and decode
step runs the mLSTM kernel from the cache's carried state
(`models.xlstm`), reading nothing back to the host.  An MoE layer
whose tokens exceed the grouped-matmul kernel's row tile reads its largest
expert count once on the host (`models.moe`).

Under an ambient mesh (`distributed.collectives.use_mesh`; the parameters
DTensors placed by `distributed.sharding.shard_model`, or global tensors)
every entry point takes the global batch and each rank computes its rows
over the data axes (all of them where the batch does not divide): every
family runs its stack tensor-parallel (`models.transformer`; the xLSTM's
blocks in `models.xlstm`, the audio model's in `models.whisper`; the
VLM's ``vision_proj`` and hymba's meta tokens are gathered whole), the
embedding goes through `collectives.embed_lookup`, the logits are
computed over the rank's vocab columns and gathered, and prefill and
decode return the global logits.  `init_cache` then builds the rank's
own part of the cache, with its ``layout`` (`transformer.kv_layout`).
`loss` returns the rank's share of the global loss, whose gradients
summed over the data axes are the global loss's, and the global values
in its metrics (``loss`` among them); where the model axis divides the
vocab, its cross-entropy runs on the rank's vocab columns
(`collectives.vocab_parallel_ce`), and the unembedding is never
gathered.

``param_shapes``, ``cache_shapes`` and ``input_specs`` give the shapes as
``device="meta"`` tensors, so that a full-size config allocates nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.convert import flat_paths
from repro_torch.core.omfs_torch import resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import map_with_names
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whisper_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import arange_positions, cache_pos_write
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    ones_init,
    rms_norm,
    stack_specs,
)

Batch = Dict[str, torch.Tensor]
Cache = Dict[str, Any]


# ---------------------------------------------------------------------------
# Chunked cross-entropy (the [B, T, V] logits are never materialised)
# ---------------------------------------------------------------------------


def _ce_chunk(hx: torch.Tensor, lx: torch.Tensor, unembed: torch.Tensor):
    """One chunk's (sum of token losses, token count): fp32 logits from
    the products of h's values and the weights rounded to h's dtype."""
    logits = hx.float() @ unembed.to(hx.dtype).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lx.clamp(min=0).long()[..., None])[..., 0]
    mask = (lx >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def chunked_ce_loss(h: torch.Tensor, unembed: torch.Tensor,
                    labels: torch.Tensor, *, chunk: int = 512
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [B, T, d], unembed [d, V], labels [B, T] (-1 = ignore) -> (sum of
    token losses, token count), fp32.  Each chunk of ``chunk`` positions
    runs under ``torch.utils.checkpoint`` (the reference's checkpointed
    scan body), so at most one chunk's ``[B, chunk, V]`` logits live at a
    time, in backward too; the last chunk may be shorter."""
    t = h.shape[1]
    chunk = min(chunk, t)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, t, chunk):
        ls, c = checkpoint(_ce_chunk, h[:, lo:lo + chunk],
                           labels[:, lo:lo + chunk], unembed,
                           use_reentrant=False, preserve_rng_state=False)
        loss_sum = loss_sum + ls
        count = count + c
    return loss_sum, count


def _logits_last(h_last: torch.Tensor, unembed: torch.Tensor) -> torch.Tensor:
    """h_last [B, T, d] -> fp32 logits [B, T, V] (small T only): the
    weights rounded to h's dtype, products and sums in fp32 (the
    reference's ``preferred_element_type=float32``)."""
    w = unembed.to(h_last.dtype)
    return h_last.float() @ w.float()


def _materialise(node: nn.Module, spec: dict, device, inits: dict,
                 prefix: str) -> None:
    """Register ``spec``'s leaves as parameters of ``node`` and its dicts as
    child modules, so that parameter paths are the reference's tree paths;
    ``inits`` collects each path's initialiser."""
    for name in sorted(spec):
        leaf = spec[name]
        if isinstance(leaf, dict):
            child = nn.Module()
            node.add_module(name, child)
            _materialise(child, leaf, device, inits, f"{prefix}{name}.")
        else:
            shape, init, dtype = leaf
            node.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))
            inits[f"{prefix}{name}"] = init


def _as_dict(node: nn.Module) -> dict:
    out = dict(node.named_parameters(recurse=False))
    for name, child in node.named_children():
        out[name] = _as_dict(child)
    return out


class Model(nn.Module):
    """One arch of ``configs/`` on ``device`` (``"cuda"`` unless the caller
    asks for ``"cpu"``; ``"meta"`` for shapes only)."""

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 q_chunk: int = 1024, kv_chunk: int = 1024):
        super().__init__()
        self.cfg = cfg
        # train-mode attention chunk sizes (the reference's Model fields)
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        self._inits: Dict[str, Any] = {}
        _materialise(self, self.param_spec(), resolve_device(device),
                     self._inits, "")

    # -- parameters ---------------------------------------------------------

    def param_spec(self) -> dict:
        cfg = self.cfg
        dtype = getattr(torch, cfg.param_dtype)
        spec: dict = {
            "embed": ((cfg.vocab, cfg.d_model), embed_init, dtype),
            "norm_f": ((cfg.d_model,), ones_init, torch.float32),
        }
        if not cfg.tie_embeddings:
            spec["unembed"] = ((cfg.d_model, cfg.vocab), dense_init, dtype)
        if cfg.n_meta_tokens:
            spec["meta"] = ((cfg.n_meta_tokens, cfg.d_model), embed_init,
                            dtype)
        if cfg.family in ("dense", "moe", "hybrid"):
            spec["blocks"] = stack_specs(tfm.block_params_spec(cfg, dtype),
                                         cfg.n_layers)
        elif cfg.family == "vlm":
            per = cfg.vision.cross_attn_every
            n_groups = cfg.n_layers // per
            spec["blocks"] = stack_specs(tfm.block_params_spec(cfg, dtype),
                                         n_groups * (per - 1))
            spec["cross"] = stack_specs(
                tfm.cross_block_params_spec(cfg, dtype), n_groups)
            spec["vision_proj"] = ((cfg.vision.vision_dim, cfg.d_model),
                                   dense_init, dtype)
        elif cfg.family == "ssm":
            n_pairs = xlstm_mod.xlstm_pair_count(cfg.n_layers, cfg.xlstm)
            spec["m_blocks"] = stack_specs(xlstm_mod.mlstm_params_spec(
                cfg.d_model, cfg.n_heads, cfg.xlstm, dtype), n_pairs)
            spec["s_blocks"] = stack_specs(xlstm_mod.slstm_params_spec(
                cfg.d_model, cfg.n_heads, cfg.xlstm, dtype), n_pairs)
        elif cfg.family == "audio":
            spec["enc"] = {
                "blocks": stack_specs(whisper_mod.enc_block_spec(cfg, dtype),
                                      cfg.audio.n_encoder_layers),
                "ln_f": whisper_mod._ln_spec(cfg.d_model)}
            spec["dec"] = {
                "blocks": stack_specs(whisper_mod.dec_block_spec(cfg, dtype),
                                      cfg.n_layers),
                "ln_f": whisper_mod._ln_spec(cfg.d_model)}
        else:
            raise ValueError(cfg.family)
        return spec

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter, in sorted path order, from ``generator``
        (on the parameters' device)."""
        params = dict(self.named_parameters())
        for path in sorted(self._inits):
            self._inits[path](params[path], generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_shapes(self) -> dict:
        """The parameter tree as ``device="meta"`` tensors (the twin of
        ``eval_shape`` over the init): no allocation."""
        return Model(self.cfg, device="meta").params()

    def params(self) -> dict:
        """The parameters as the reference's nested dict of tensors."""
        return _as_dict(self)

    def release(self) -> "Model":
        """Drop every parameter's storage: the parameters become
        ``device="meta"`` tensors of the same shapes and dtypes."""
        return self.to_empty(device="meta")

    def materialise(self, device) -> "Model":
        """Allocate every parameter, uninitialised, on ``device``."""
        return self.to_empty(device=resolve_device(device))

    @torch.no_grad()
    def adopt(self, params: dict) -> "Model":
        """Make the tensors of ``params`` (a tree shaped like ``params()``,
        e.g. a restored checkpoint's) the model's parameters, sharing their
        storage.  Raises on a missing or extra path, a shape or a dtype."""
        mine = dict(self.named_parameters())
        leaves = flat_paths(params)
        if mine.keys() != leaves.keys():
            raise KeyError(f"params paths differ: missing "
                           f"{sorted(mine.keys() - leaves.keys())}, extra "
                           f"{sorted(leaves.keys() - mine.keys())}")
        for path, t in leaves.items():
            p = mine[path]
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, the "
                                 f"model holds {tuple(p.shape)} {p.dtype}")
        for path, t in leaves.items():
            owner, _, name = path.rpartition(".")
            module = self.get_submodule(owner) if owner else self
            module._parameters[name] = nn.Parameter(t.detach())
        return self

    # -- sharded execution --------------------------------------------------

    #: the leaves that the tensor-parallel stack takes as placed, each
    #: layer's share of them where the layer runs (GQA, the FFN and the
    #: MoE; MLA's up- and down-projections; the SSM's matrices and
    #: ``a_log``, `models.ssm.local_params`; the mLSTM's and sLSTM's
    #: matrices, gate vectors and ``gn``, `models.xlstm`; whisper's q and
    #: v biases and its MLP's ``b_in``, `models.whisper`); it takes every
    #: other leaf (the norms and the replicated vectors above all; the
    #: biases whisper adds after a row-parallel sum, ``b_o`` and
    #: ``b_out``) whole
    _TP_LEAVES = frozenset({
        "w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down", "router",
        "embed", "unembed",
        "w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "w_kr",
        "w_in", "conv_w", "conv_b", "w_xproj", "w_dt", "a_log", "w_out",
        "w_i", "w_f", "b_i", "b_f", "gn", "w_gates", "r_gates",
        "b_q", "b_v", "b_in"})

    def _spmd_params(self, params, mesh):
        """The tree a sharded forward computes with: the leaves that the
        tensor-parallel stack takes as placed stay DTensors (the VLM's
        cross blocks' matrices among them), and each layer takes its
        share, or gathers the layer's whole leaf, where it runs; every
        other DTensor is gathered whole (an explicit all-gather; a
        replicated one is its local tensor: the norms, hymba's meta
        tokens, the VLM's gates and its 1,280 x 4,096 ``vision_proj``,
        whose whole weights move fewer bytes than gathering its [B, P, d]
        output would).  A `collectives.Stacked` leaf (the sharded train
        step's) stays in its shards and is gathered, the same way, a
        layer at a time where the stack runs it."""
        def view(names, w):
            keep = names[-1] in self._TP_LEAVES
            if isinstance(w, col.Stacked):     # gathered a layer at a time
                return w.viewed(whole=not keep)
            if col._is_dtensor(w) and not keep:
                return self._whole(w, names[-1])
            return w

        return map_with_names(view, params)

    def _xlstm_tp(self, mesh) -> int:
        """How many ways the xLSTM's state splits over ``mesh``'s model
        axis (`models.xlstm.heads_split`): 1 without a mesh or where the
        heads do not divide it."""
        split = xlstm_mod.heads_split(self.cfg.n_heads, mesh)
        return col.tp_size(mesh) if split else 1

    @staticmethod
    def _dp_rows(x, mesh):
        """(this rank's rows of a global [B, ...] input over the data
        axes, whether it was split): every row where B does not divide."""
        n = col.dp_size(mesh)
        if x is None or n == 1 or x.shape[0] % n:
            return x, False
        b = x.shape[0] // n
        r = col.dp_rank(mesh)
        return x[r * b:(r + 1) * b], True

    def _global_rows(self, y, mesh, split: bool):
        if mesh is None or not split:
            return y
        return col.all_gather(y, col.dp_group(mesh), 0)

    # -- embedding helpers --------------------------------------------------

    def _embed(self, params, tokens):
        table = params["embed"]
        mesh = col.current_mesh()
        if mesh is None:
            x = table[tokens]
        elif (col.usable_mesh() is not None
              and table.shape[-1] % col.tp_size(mesh) == 0):
            x = col.gather(col.embed_lookup(table, tokens, mesh),
                           col.tp_group(mesh), -1)
        else:
            x = col.full(table)[tokens]
        return x.to(getattr(torch, self.cfg.compute_dtype))

    def _vocab_split(self):
        """The usable mesh whose model axis splits the untied unembedding
        by vocab columns, else None."""
        mesh = col.usable_mesh()
        if (mesh is not None and not self.cfg.tie_embeddings
                and self.cfg.vocab % col.tp_size(mesh) == 0):
            return mesh
        return None

    def _logits(self, params, h_last):
        """`_logits_last` over the whole vocab; under a usable mesh each
        rank takes its vocab columns and the logits are gathered."""
        mesh = self._vocab_split()
        if mesh is not None:
            w = col.tp_local(params["unembed"], -1, mesh)
            return col.all_gather(_logits_last(h_last, w),
                                  col.tp_group(mesh), -1)
        return _logits_last(h_last, self._unembed_matrix(params))

    def _unembed_matrix(self, params):
        """The [d, V] unembedding, whole (a DTensor gathered)."""
        if self.cfg.tie_embeddings:
            return self._whole(params["embed"], "embed").T
        return self._whole(params["unembed"], "unembed")

    @staticmethod
    def _whole(w, name: str):
        """``collectives.full(w)``, counting a gathered unembedding in
        ``COLLECTIVES["unembed_gather"]``."""
        if name == "unembed" and col._is_dtensor(w):
            col.COLLECTIVES["unembed_gather"] += 1
        return col.full(w)

    def _positions(self, batch_size: int, start, length: int):
        pos = start + torch.arange(length, dtype=torch.int32,
                                   device=self.device)[None, :]
        return pos.expand(batch_size, length)

    # -- trunk --------------------------------------------------------------

    def _trunk(self, params, x, positions, *, mode, cache, batch=None):
        """Run the layer stack: (h after the final norm, the cache's
        layers, written in place (None in train mode), the aux loss)."""
        cfg = self.cfg
        chunks = dict(q_chunk=self.q_chunk, kv_chunk=self.kv_chunk)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kw = {}
        if cache is not None:
            kw = dict(cache=cache["layers"], kv_pos=cache.get("pos"),
                      cursor=cache["length"])
        if cfg.family in ("dense", "moe", "hybrid"):
            layout = cache.get("layout") if cache is not None else None
            h, layers, aux = tfm.stack_apply(
                cfg, params["blocks"], x, positions, mode=mode, **kw,
                **chunks, kv_layout=layout)
        elif cfg.family == "vlm":
            vision = None
            if mode != "decode":
                vision = batch["frontend"].to(x.dtype) @ params[
                    "vision_proj"].to(x.dtype)
            layout = cache.get("layout") if cache is not None else None
            h, layers, aux = tfm.vlm_stack_apply(
                cfg, {"blocks": params["blocks"], "cross": params["cross"]},
                x, positions, mode=mode, vision_states=vision, **kw,
                **chunks, kv_layout=layout)
        elif cfg.family == "ssm":
            if cache is None:
                n_pairs = xlstm_mod.xlstm_pair_count(cfg.n_layers, cfg.xlstm)
                state = xlstm_mod.XLSTMStackState.init(
                    n_pairs, x.shape[0], cfg.d_model, cfg.n_heads, cfg.xlstm,
                    x.dtype, x.device, self._xlstm_tp(tfm.spmd_mesh(cfg)))
            else:
                state = cache["layers"]
            h, layers = xlstm_mod.xlstm_stack_apply(
                cfg.xlstm, cfg.n_heads, params, x, state,
                mode="train" if mode == "train" else "serve",
                mesh=tfm.spmd_mesh(cfg))
        elif cfg.family == "audio":
            enc_out = None
            mesh = tfm.spmd_mesh(cfg)
            if mode != "decode":
                enc_out = whisper_mod.encoder_forward(
                    cfg, params["enc"], batch["frontend"].to(x.dtype),
                    mode=mode, mesh=mesh)
            # the decoder ends in its own LayerNorm
            h, layers = whisper_mod.decoder_forward(
                cfg, params["dec"], x, positions, enc_out, mode=mode,
                mesh=mesh, **kw)
            return h, layers, aux
        else:
            raise ValueError(cfg.family)
        return rms_norm(h, params["norm_f"], cfg.norm_eps), layers, aux

    # -- training -----------------------------------------------------------

    def loss(self, batch: Batch, params=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The causal-LM loss over a [B, T] batch of ``tokens`` and
        ``labels`` (and the VLM's or the audio model's ``frontend``):
        (``ce + aux / n_layers``, {ce_loss, aux_loss, tokens}), fp32, with
        autograd through ``params`` (default: the model's own).  Under a
        mesh whose model axis runs the stack tensor-parallel and divides
        the untied vocab, the cross-entropy is `collectives.
        vocab_parallel_ce` on the rank's unembedding columns; elsewhere
        `chunked_ce_loss` on the whole unembedding, gathered (a vocab that
        the model axis does not divide, as hymba's 32,001 and whisper's
        51,865)."""
        cfg = self.cfg
        params = self.params() if params is None else params
        tokens, labels = batch["tokens"], batch["labels"]
        mesh = col.current_mesh()
        if mesh is not None:
            params = self._spmd_params(params, mesh)
            tokens, split = self._dp_rows(tokens, mesh)
            labels, _ = self._dp_rows(labels, mesh)
            if "frontend" in batch:
                batch = dict(batch,
                             frontend=self._dp_rows(batch["frontend"],
                                                    mesh)[0])
        b, t = tokens.shape
        x = self._embed(params, tokens)
        nm = cfg.n_meta_tokens
        if nm:
            meta = params["meta"].to(x.dtype)[None].expand(b, nm, cfg.d_model)
            x = torch.cat([meta, x], dim=1)
        positions = self._positions(b, 0, t + nm)
        h, _, aux = self._trunk(params, x, positions, mode="train",
                                cache=None, batch=batch)
        vocab = self._vocab_split()
        if vocab is not None:
            loss_sum, count = col.vocab_parallel_ce(
                h[:, nm:], col.tp_local(params["unembed"], -1, vocab),
                labels, vocab)
        else:
            loss_sum, count = chunked_ce_loss(
                h[:, nm:], self._unembed_matrix(params), labels)
        if mesh is not None:
            return self._sharded_loss(loss_sum, count, aux, mesh, split)
        loss = loss_sum / torch.clamp(count, min=1.0)
        total = loss + aux / max(cfg.n_layers, 1)
        return total, {"ce_loss": loss, "aux_loss": aux, "tokens": count}

    def _sharded_loss(self, loss_sum, count, aux, mesh, split: bool):
        """From this rank's CE sum and token count: its share of the
        global loss (the shares' gradients summed over the data axes are
        the global loss's) and the global metrics.  A rank's rows are a
        split of the batch, or all of it on every data rank."""
        cfg = self.cfg
        grp = col.dp_group(mesh)
        if split:
            count = col.all_reduce(count, grp)
            share = loss_sum / torch.clamp(count, min=1.0)
        else:
            share = (loss_sum / torch.clamp(count, min=1.0)
                     / col.dp_size(mesh))
        ce = col.all_reduce(share.detach(), grp)
        layers = max(cfg.n_layers, 1)
        return share + aux / layers, {
            "ce_loss": ce, "aux_loss": aux.detach(), "tokens": count,
            "loss": ce + aux.detach() / layers}

    # -- serving ------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch: Batch, cache: Cache) -> Tuple[Cache, torch.Tensor]:
        """Populate the cache from a [B, S] prompt (``batch["tokens"]``,
        and the VLM's or the audio model's ``batch["frontend"]``); returns
        (cache, last-token fp32 logits [B, 1, V])."""
        cfg = self.cfg
        params = self.params()
        tokens = batch["tokens"]
        mesh = col.current_mesh()
        split = False
        if mesh is not None:
            params = self._spmd_params(params, mesh)
            tokens, split = self._dp_rows(tokens, mesh)
            if "frontend" in batch:
                batch = dict(batch,
                             frontend=self._dp_rows(batch["frontend"],
                                                    mesh)[0])
        b, t = tokens.shape
        x = self._embed(params, tokens)
        nm = cfg.n_meta_tokens
        if nm:
            meta = params["meta"].to(x.dtype)[None].expand(b, nm, cfg.d_model)
            x = torch.cat([meta, x], dim=1)
        # arange(S) by construction: the flash guard reads nothing back
        positions = arange_positions(b, t + nm, tokens.device)
        h, layers, _ = self._trunk(params, x, positions, mode="prefill",
                                   cache=cache, batch=batch)
        new_cache = dict(cache, layers=layers)
        if "pos" in cache:
            new_cache["pos"] = self._pos_write(cache, positions, mesh)
        new_cache["length"] = cache["length"] + (t + nm)
        logits = self._logits(params, h[:, -1:])
        return new_cache, self._global_rows(logits, mesh, split)

    def _pos_write(self, cache, positions, mesh):
        if cache.get("layout") == "seq":
            return tfm.seq_write(cache["pos"], positions, cache["length"],
                                 mesh)
        return cache_pos_write(cache["pos"], positions, cache["length"],
                               n_pinned=self.cfg.n_meta_tokens)

    @torch.no_grad()
    def decode_step(self, cache: Cache,
                    tokens: torch.Tensor) -> Tuple[Cache, torch.Tensor]:
        """One decode step: tokens [B, T_small] -> (cache, fp32 logits
        [B, T_small, V])."""
        params = self.params()
        mesh = col.current_mesh()
        split = False
        if mesh is not None:
            params = self._spmd_params(params, mesh)
            tokens, split = self._dp_rows(tokens, mesh)
        b, t = tokens.shape
        x = self._embed(params, tokens)
        positions = self._positions(b, cache["length"], t)
        new_cache = dict(cache)
        if "pos" in cache:
            # positions first, so that attention sees the new token's slot
            new_cache["pos"] = self._pos_write(cache, positions, mesh)
        h, layers, _ = self._trunk(params, x, positions, mode="decode",
                                   cache=new_cache)
        new_cache["layers"] = layers
        new_cache["length"] = cache["length"] + t
        logits = self._logits(params, h)
        return new_cache, self._global_rows(logits, mesh, split)

    # -- caches -------------------------------------------------------------

    def cache_slots(self, max_seq: int) -> int:
        cfg = self.cfg
        if cfg.sliding_window:
            return min(max_seq, cfg.sliding_window + cfg.n_meta_tokens)
        return max_seq

    def init_cache(self, batch_size: int, max_seq: int,
                   dtype=torch.bfloat16) -> Cache:
        """The cache of a global batch; under an ambient mesh this
        rank's part of it."""
        return self._init_cache(batch_size, max_seq, dtype, self.device,
                                col.current_mesh())

    def cache_shapes(self, batch_size: int, max_seq: int,
                     dtype=torch.bfloat16) -> Cache:
        """The global cache's tree as ``device="meta"`` tensors."""
        return self._init_cache(batch_size, max_seq, dtype, "meta", None)

    def input_specs(self, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
        """``device="meta"`` stand-ins for every model input of a
        `ShapeSpec`."""
        cfg = self.cfg
        b = shape.global_batch

        def spec(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        specs: Dict[str, torch.Tensor] = {}
        if shape.kind == "train":
            specs["tokens"] = spec(b, shape.seq_len)
            specs["labels"] = spec(b, shape.seq_len)
        elif shape.kind == "prefill":
            specs["tokens"] = spec(b, shape.seq_len)
        elif shape.kind == "decode":
            specs["tokens"] = spec(b, 1)
        if cfg.family == "vlm" and shape.kind != "decode":
            specs["frontend"] = spec(b, cfg.vision.n_patches,
                                     cfg.vision.vision_dim,
                                     dtype=torch.bfloat16)
        if cfg.family == "audio" and shape.kind != "decode":
            specs["frontend"] = spec(b, cfg.audio.n_audio_ctx, cfg.d_model,
                                     dtype=torch.bfloat16)
        return specs

    def _init_cache(self, batch_size: int, max_seq: int, dtype, dev,
                    mesh) -> Cache:
        """The cache (`init_cache`); under ``mesh``, where the stack runs
        tensor-parallel, the rank's box of it over the model axis, which
        ``layout`` names (`transformer.kv_layout`): the self cache's
        sequence, KV heads or head_dim, MLA's latent columns ("latent":
        ``kv_lora_rank / TP`` of ``ckv``, ``qk_rope_head_dim / TP`` of
        ``kr``); the hybrid's ``ssm_h`` and ``ssm_conv`` hold the rank's
        ``d_inner / TP`` channels where `transformer.ssm_split` holds.  The VLM's vision cache ``xk`` /
        ``xv`` takes the same layout but never the sequence split (the
        reference's ``cache_shardings`` splits only the self cache's
        sequence): under "seq" it takes `transformer.cross_kv_layout`, its
        KV heads, else head_dim, else whole.  The audio model's ``k``,
        ``v``, ``xk`` and ``xv`` take `transformer.cross_kv_layout`: the
        rank's KV heads where the model axis divides them, as the
        reference places them, else whole.  The xLSTM's state (layout
        "heads" where `models.xlstm.heads_split` holds, else "full") holds
        the rank's heads: the mLSTM's ``c`` [P, B, H / TP, dh, dh], ``m``
        [P, B, H / TP] and its conv window's ``d_inner / TP`` channels,
        the sLSTM's ``h``, ``c``, ``n``, ``m`` and conv window on the
        heads' ``d / TP`` units, as the reference places them; and the
        mLSTM's ``n`` [P, B, H / TP, dh], which the reference splits by
        ``dh`` instead (its generic rule tries the last dim first), so
        that a rank's scan reads its heads' state whole.  The batch is
        over the data axes."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        s = self.cache_slots(max_seq + cfg.n_meta_tokens)
        b = batch_size
        s_kv, kvh, hd_kv, layout = s, cfg.n_kv_heads, hd, None
        x_kvh, x_hd = kvh, hd

        def split(lay):              # (KV heads, head_dim) a rank holds
            tp = col.tp_size(mesh)
            if lay == "heads":
                return cfg.n_kv_heads // tp, hd
            if lay == "head_dim":
                return cfg.n_kv_heads, hd // tp
            return cfg.n_kv_heads, hd

        if mesh is not None:
            n = col.dp_size(mesh)
            b = b // n if b % n == 0 else b
            # the xLSTM's and whisper's caches split by heads only
            layout = (tfm.cross_kv_layout(cfg, mesh)
                      if cfg.family in ("ssm", "audio")
                      else tfm.kv_layout(cfg, mesh, s))
            if layout == "seq":
                s_kv = s // col.tp_size(mesh)
            kvh, hd_kv = split(layout)
            x_kvh, x_hd = split(tfm.cross_kv_layout(cfg, mesh))
        cache: Cache = {"length": torch.zeros((), dtype=torch.int32,
                                              device=dev)}
        if cfg.family == "ssm":
            n_pairs = xlstm_mod.xlstm_pair_count(cfg.n_layers, cfg.xlstm)
            cache["layers"] = xlstm_mod.XLSTMStackState.init(
                n_pairs, b, cfg.d_model, cfg.n_heads, cfg.xlstm, dtype, dev,
                self._xlstm_tp(mesh))
            if mesh is not None:
                cache["layout"] = ("heads" if xlstm_mod.heads_split(
                    cfg.n_heads, mesh) else "full")
            return cache
        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        n_self = cfg.n_layers
        if cfg.family == "vlm":
            per = cfg.vision.cross_attn_every
            n_self = cfg.n_layers // per * (per - 1)
        if cfg.mla is not None:
            lat = col.tp_size(mesh) if layout == "latent" else 1
            layers = {"ckv": zeros(n_self, b, s, cfg.mla.kv_lora_rank // lat),
                      "kr": zeros(n_self, b, s,
                                  cfg.mla.qk_rope_head_dim // lat)}
        else:
            layers = {"k": zeros(n_self, b, s_kv, kvh, hd_kv),
                      "v": zeros(n_self, b, s_kv, kvh, hd_kv)}
        if cfg.family == "vlm":
            n_groups = cfg.n_layers // cfg.vision.cross_attn_every
            for name in ("xk", "xv"):
                layers[name] = zeros(n_groups, b, cfg.vision.n_patches,
                                     x_kvh, x_hd)
        if cfg.family == "audio":
            for name in ("xk", "xv"):
                layers[name] = zeros(cfg.n_layers, b, cfg.audio.n_audio_ctx,
                                     x_kvh, x_hd)
        if cfg.family == "hybrid":
            di = cfg.ssm.expand * cfg.d_model
            if layout is not None and tfm.ssm_split(cfg, mesh):
                di //= col.tp_size(mesh)
            layers["ssm_h"] = torch.zeros(
                (cfg.n_layers, b, di, cfg.ssm.d_state), dtype=torch.float32,
                device=dev)
            layers["ssm_conv"] = torch.zeros(
                (cfg.n_layers, b, cfg.ssm.d_conv - 1, di), dtype=dtype,
                device=dev)
        cache["layers"] = layers
        cache["pos"] = torch.full((b, s_kv), -1, dtype=torch.int32,
                                  device=dev)
        if layout is not None:
            cache["layout"] = layout
        return cache


def frontend_stub(cfg: ModelConfig, batch_size: int, device):
    """The stub frontend the reference's launchers feed the VLM and the
    audio model, zero bf16 embeddings: [B, n_patches, vision_dim] patches
    or [B, n_audio_ctx, d_model] frames; None for the other families."""
    if cfg.family == "vlm":
        shape = (batch_size, cfg.vision.n_patches, cfg.vision.vision_dim)
    elif cfg.family == "audio":
        shape = (batch_size, cfg.audio.n_audio_ctx, cfg.d_model)
    else:
        return None
    return torch.zeros(shape, dtype=torch.bfloat16,
                       device=resolve_device(device))


def resolve_frontend(cfg: ModelConfig, frontend: Optional[torch.Tensor],
                     batch_size: int, device) -> Optional[torch.Tensor]:
    """The frontend a batch of ``batch_size`` rows carries: ``frontend``
    where given (only the VLM and the audio model take one: the other
    families raise ValueError), else `frontend_stub`'s."""
    if frontend is None:
        return frontend_stub(cfg, batch_size, device)
    if cfg.family not in ("vlm", "audio"):
        raise ValueError(f"{cfg.name} takes no frontend")
    return frontend


def count_params(cfg: ModelConfig) -> dict:
    """Counts from the parameter shapes (a ``device="meta"`` model), in the
    reference's keys; ``active`` leaves out the routed experts that a token
    does not use."""
    model = Model(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    active = total
    if cfg.moe is not None:
        per_expert = 3 * cfg.d_model * cfg.moe.d_expert * cfg.n_layers
        active = total - (cfg.moe.n_routed - cfg.moe.top_k) * per_expert
    # "active" for FLOPs excludes the input embedding gather (not a matmul)
    return {"total": total, "active": active,
            "active_flops": active - cfg.vocab * cfg.d_model,
            "embedding": embed}


def model_flops_per_step(cfg: ModelConfig, shape: ShapeSpec,
                         backward: bool) -> float:
    """MODEL_FLOPS = 6*N*D (training) or 2*N*D (inference) with N = active
    matmul params, D = tokens processed in the step."""
    n = count_params(cfg)["active_flops"]
    d = shape.tokens_per_step
    return (6.0 if backward else 2.0) * n * d
