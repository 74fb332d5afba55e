"""Config-driven decoder models: dense, MoE, Mamba2 SSM and the Zamba2 hybrid.

The port of the JAX package's ``models/transformer.py`` for every
architecture family:

  * dense, vlm, audio : a stack of (attention + MLP) blocks, SwiGLU or
             GELU (vlm and audio are the dense stack behind a stub
             frontend, whose embeddings ``prefill(embeds=)`` takes);
  * moe    : ``first_dense_layers`` unrolled dense blocks (``dense_{i}``),
             then a stack of (attention + MoE) blocks; DeepSeek-V3's
             ``mtp/*`` parameters are created (training uses them, serving
             does not);
  * ssm    : a stack of Mamba2 blocks;
  * hybrid : superblocks of ``shared_attn_every`` Mamba2 sublayers followed
             by one call of a single weight-shared attention block (one
             weight set, ``shared_attn/...``, but one KV cache per
             superblock; no MLP).

Attention is GQA or MLA, by ``attention_kind``, in every family, as in the
reference; MLA keeps the flat (or ring) latent cache and has no paged one.

Methods: ``init``, ``embed``, ``logits``, ``hidden`` / ``forward`` (the
full-sequence training forward, no cache; ``remat`` recomputes each
stacked block in the backward, as the reference's ``jax.checkpoint`` over
its scan body), ``prefill``, ``init_cache`` /
``decode_step`` (flat KV; a ring of ``sliding_window`` rows when the
window is shorter than ``max_len``), ``init_paged_cache`` /
``decode_step_paged`` (paged KV; GQA without a window) and
``scatter_prefill``.  Parameters are a plain nested dict with the JAX key
tree; per-layer (or per-superblock) parameters are stacked along a
leading axis, and the JAX ``lax.scan`` over that axis becomes a Python
loop.

Caches are updated in place (see :mod:`repro_torch.models.attention` and
:mod:`repro_torch.models.ssm`); the methods still return them, as the
reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    DTYPES, ParamSpec, PartitionSpec, batch_spec, constrain, embedding, init_params,
    is_dtensor, resolve_device, rmsnorm, settle,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp_forward, mlp_specs

Params = Dict[str, Any]
Device = Union[str, torch.device]

# arch types served as the dense block stack, as the reference's are
DENSE_TYPES = ("dense", "vlm", "audio")
# arch types built of (attention + MLP or MoE) blocks
BLOCK_TYPES = DENSE_TYPES + ("moe",)


def _attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return attn.mla_specs(cfg) if cfg.attention_kind == "mla" else attn.gqa_specs(cfg)


def _attn_prefill(p: Params, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
                  kv_hint: Optional[PartitionSpec] = None):
    if cfg.attention_kind == "mla":
        return attn.mla_prefill(p, cfg, h, positions, kv_hint)
    return attn.gqa_prefill(p, cfg, h, positions, kv_hint)


def _attn_forward(p: Params, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
                  kv_hint: Optional[PartitionSpec] = None):
    if cfg.attention_kind == "mla":
        return attn.mla_forward(p, cfg, h, positions, kv_hint)
    return attn.gqa_forward(p, cfg, h, positions, kv_hint)


def _attn_init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device):
    make = attn.mla_init_cache if cfg.attention_kind == "mla" else attn.gqa_init_cache
    return make(cfg, batch, max_len, DTYPES[cfg.dtype], device)


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter (or cache) tree, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _unbind(tree: Params, n: int) -> List[Params]:
    """The ``n`` layers of a stacked parameter tree, as views from one
    ``unbind`` a leaf, whose backward stacks the layers' gradients once
    (indexing layer by layer would build a whole-stack gradient a layer)."""
    parts = {k: _unbind(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: part[i] for k, part in parts.items()} for i in range(n)]


def _stack(trees: List[Params]) -> Params:
    """Per-layer trees of tensors -> one tree stacked along a new axis 0."""
    return {
        k: _stack([t[k] for t in trees]) if isinstance(v, dict)
        else torch.stack([t[k] for t in trees])
        for k, v in trees[0].items()
    }


def _repeat_stacked(template: Params, n: int) -> Params:
    """``n`` copies of ``template`` stacked along a new leading axis (zeros,
    and a ring cache's ``slot_pos`` of -1)."""
    return {
        k: _repeat_stacked(v, n) if isinstance(v, dict)
        else v.unsqueeze(0).repeat((n,) + (1,) * v.dim())
        for k, v in template.items()
    }


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    # recompute each stacked block in the backward of :meth:`hidden`
    # (serving ignores it)
    remat: bool = True
    # the mesh's axis names, whose data axes :meth:`cache_specs` shards the
    # batch over
    mesh_axes: Tuple[str, ...] = ("data", "model")
    # a DeviceMesh with a "model" axis: the MoE layers then dispatch expert
    # parallel over it (``moe_forward_shard_map``)
    moe_mesh: Any = None
    # the reference's in-model sharding knobs, as partition specs that a
    # DTensor is redistributed to where the reference constrains it (plain
    # tensors ignore them):
    # the residual stream after each sublayer of the training blocks, in
    # place of the batch-only ``settle`` (the reference's ``act_tp``:
    # P(dp, None, "model"), tensor-parallel all-reduces become
    # reduce-scatter and all-gather pairs)
    act_tp: Optional[PartitionSpec] = None
    # k/v of the full-sequence attention, once above the attention
    kv_hint: Optional[PartitionSpec] = None
    # the MoE (E, C, d) expert buffer (P("model", "data", None) splits the
    # capacity over "data", so each data shard runs its slots only)
    moe_buf_spec: Optional[PartitionSpec] = None

    def __post_init__(self):
        cfg = self.cfg
        # ``modality`` names the frontend only: the reference's model reads
        # embeddings or token ids the same way for every modality
        if cfg.arch_type != "ssm" and cfg.attention_kind not in ("gqa", "mla"):
            raise NotImplementedError(
                f"{cfg.name}: attention_kind={cfg.attention_kind!r} is served only by "
                "the pure SSM family"
            )
        if cfg.arch_type == "hybrid" and (
            cfg.shared_attn_every < 1 or cfg.num_layers % cfg.shared_attn_every
        ):
            raise ValueError(
                f"{cfg.name}: hybrid depth {cfg.num_layers} must be a multiple of "
                f"shared_attn_every={cfg.shared_attn_every}"
            )

    @property
    def depth(self) -> int:
        """Length of the stacked ``layers`` axis: layers, superblocks, or
        the MoE blocks after the unrolled dense ones."""
        cfg = self.cfg
        if cfg.arch_type == "hybrid":
            return cfg.num_layers // cfg.shared_attn_every
        return cfg.num_layers - self.n_dense

    @property
    def n_dense(self) -> int:
        """The MoE family's unrolled ``dense_{i}`` blocks (0 elsewhere)."""
        return self.cfg.first_dense_layers if self.cfg.arch_type == "moe" else 0

    def _blocks(self, tree: Params) -> List[Params]:
        """Per-block views of a parameter or cache tree, in order: the
        unrolled ``dense_{i}`` blocks, then each layer of the stack."""
        return ([tree[f"dense_{i}"] for i in range(self.n_dense)]
                + [_layer(tree["layers"], i) for i in range(self.depth)])

    # ------------------------------------------------------------------ init --
    def param_specs(self) -> Dict[str, ParamSpec]:
        """Flat ``/``-joined key path -> (shape, init, scale, partition
        spec): the key tree, shapes and specs of the JAX ``Model.init``."""
        cfg = self.cfg
        d = cfg.d_model
        specs: Dict[str, ParamSpec] = {
            "embed": ((cfg.padded_vocab, d), "normal", 0.02, ("model", None)),
        }
        if not cfg.tie_embeddings:
            specs["head"] = ((d, cfg.padded_vocab), "normal", None, (None, "model"))
        specs["final_norm"] = ((d,), "ones", None, (None,))
        ln: ParamSpec = ((d,), "ones", None, (None,))

        def attn_block(ffn: str, ffn_specs: Dict[str, ParamSpec]) -> Dict[str, ParamSpec]:
            return {"ln1": ln, **{f"attn/{k}": s for k, s in _attn_specs(cfg).items()},
                    "ln2": ln, **{f"{ffn}/{k}": s for k, s in ffn_specs.items()}}

        block: Dict[str, ParamSpec] = {}
        if cfg.arch_type in DENSE_TYPES:
            block = attn_block("mlp", mlp_specs(cfg))
        elif cfg.arch_type == "moe":
            for i in range(self.n_dense):
                specs.update({f"dense_{i}/{k}": s
                              for k, s in attn_block("mlp", mlp_specs(cfg)).items()})
            block = attn_block("moe", moe_mod.moe_specs(cfg))
        elif cfg.arch_type == "ssm":
            block["ln"] = ln
            block.update(ssm_mod.ssm_specs(cfg))
        else:  # hybrid
            specs["shared_attn/ln"] = ln
            specs.update({f"shared_attn/{k}": s for k, s in _attn_specs(cfg).items()})
            for i in range(cfg.shared_attn_every):
                block[f"mamba_{i}/ln"] = ln
                block.update({f"mamba_{i}/{k}": s for k, s in ssm_mod.ssm_specs(cfg).items()})
        for k, (shape, init, scale, part) in block.items():
            specs[f"layers/{k}"] = ((self.depth,) + shape, init, scale, (None,) + part)
        if cfg.mtp:
            specs["mtp/proj"] = ((2 * d, d), "normal", None, (None, "model"))
            specs["mtp/norm"] = ((d,), "ones", None, (None,))
        return specs

    def param_partition_specs(self) -> Dict[str, PartitionSpec]:
        """Flat key path -> the parameter's partition spec: one entry a
        dimension, a mesh axis name or None (the JAX ``ParamFactory``'s
        ``PartitionSpec``s; the stacked layer axis is never sharded)."""
        return {k: spec[3] for k, spec in self.param_specs().items()}

    def init(self, seed: int = 0, device: Device = "cuda") -> Params:
        """Random parameters from ``seed`` (a ``torch.Generator`` on
        ``device``), in the config's dtype."""
        return init_params(
            self.param_specs(), seed, resolve_device(device), DTYPES[self.cfg.dtype]
        )

    # --------------------------------------------------------------- forward --
    def embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return embedding(params["embed"], tokens)

    def logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        out = h @ head
        if cfg.padded_vocab != cfg.vocab_size:
            # mask the padding ids so sampling/softmax never sees them; in
            # place is safe under autograd, since the product saves its
            # inputs and not its output, and the padded ids get gradient 0
            if is_dtensor(out):  # sharded over the vocabulary, maybe partial
                pad = torch.arange(cfg.padded_vocab, device=out.device) >= cfg.vocab_size
                out = out.masked_fill(pad, -1e30)
            else:
                out[..., cfg.vocab_size:] = -1e30
        return out

    def _ffn_residual(self, lp: Params, x: torch.Tensor) -> torch.Tensor:
        """A block's second half: its MLP, or its MoE (the aux loss is for
        training and is dropped here, as the reference's serving drops it)."""
        h = rmsnorm(x, lp["ln2"], self.cfg.norm_eps)
        if "moe" in lp:
            return x + settle(self._moe(lp["moe"], h)[0])
        return x + settle(mlp_forward(lp["mlp"], h))

    def _moe(self, p: Params, h: torch.Tensor):
        """The MoE layer: expert parallel over ``moe_mesh``'s "model" axis
        when the model has one, else the capacity dispatch."""
        mesh = self.moe_mesh
        if mesh is None:
            return moe_mod.moe_forward(p, self.cfg, h, self.moe_buf_spec)
        dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
        return moe_mod.moe_forward_shard_map(p, self.cfg, h, mesh, dp_axes=dp)

    # --------------------------------------------------------------- training --
    def _train_block(
        self, lp: Params, x: torch.Tensor, positions: torch.Tensor,
        shared: Optional[Params] = None,
    ):
        """One block (or hybrid superblock) over the full sequence, without a
        cache; returns (x, the block's MoE aux loss or 0.0)."""
        cfg = self.cfg
        eps = cfg.norm_eps
        if cfg.arch_type in BLOCK_TYPES:
            # settle(x) is x itself, unless act_tp left it sharded over its
            # features: then it is the all-gather before the sublayer
            a = _attn_forward(lp["attn"], cfg, rmsnorm(settle(x), lp["ln1"], eps), positions,
                              self.kv_hint)
            x = self._residual(x, a)
            h = rmsnorm(settle(x), lp["ln2"], eps)
            if "moe" in lp:
                out, aux = self._moe(lp["moe"], h)
                return self._residual(x, out), aux
            return self._residual(x, mlp_forward(lp["mlp"], h)), 0.0
        if cfg.arch_type == "ssm":
            return x + settle(ssm_mod.ssm_forward(lp, cfg, rmsnorm(x, lp["ln"], eps))), 0.0
        for j in range(cfg.shared_attn_every):  # hybrid superblock
            mp = lp[f"mamba_{j}"]
            x = x + settle(ssm_mod.ssm_forward(mp, cfg, rmsnorm(x, mp["ln"], eps)))
        a = _attn_forward(shared, cfg, rmsnorm(x, shared["ln"], eps), positions)
        return x + settle(a), 0.0

    def _residual(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``x + y`` in a training block: ``y`` settled, or with ``act_tp``
        both placed by it, as the reference constrains the sum."""
        if self.act_tp is None:
            return x + settle(y)
        return constrain(x, self.act_tp) + constrain(y, self.act_tp)

    def hidden(
        self,
        params: Params,
        tokens: Optional[torch.Tensor] = None,  # (B, S) int
        embeds: Optional[torch.Tensor] = None,  # (B, S, d_model) frontend embeddings
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward up to the (pre-final-norm) hidden states;
        returns (h, the MoE aux loss summed over the MoE layers, float32).
        The MoE family's ``dense_{i}`` blocks are not recomputed, as in the
        reference; with ``remat`` every stacked block is."""
        cfg = self.cfg
        x = self.embed(params, tokens) if embeds is None else embeds.to(DTYPES[cfg.dtype])
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.n_dense):
            x, _ = self._train_block(params[f"dense_{i}"], x, positions)
        shared = params.get("shared_attn")
        for lp in _unbind(params["layers"], self.depth):
            if self.remat:
                x, a = checkpoint(self._train_block, lp, x, positions, shared,
                                  use_reentrant=False)
            else:
                x, a = self._train_block(lp, x, positions, shared)
            aux = aux + a
        return x, aux

    def forward(
        self,
        params: Params,
        tokens: Optional[torch.Tensor] = None,
        embeds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward; returns (logits, aux loss)."""
        h, aux = self.hidden(params, tokens=tokens, embeds=embeds)
        return self.logits(params, h), aux

    # ---------------------------------------------------------------- prefill --
    def prefill(
        self,
        params: Params,
        tokens: Optional[torch.Tensor] = None,  # (B, S) int
        lengths: Optional[torch.Tensor] = None,  # (B,) true lengths of right-padded rows
        embeds: Optional[torch.Tensor] = None,  # (B, S, d_model) frontend embeddings
    ) -> Tuple[torch.Tensor, Params]:
        """Full-sequence serving prefill: last-token logits (at ``lengths-1``
        for right-padded rows) and the decode cache of every layer, stacked
        along a leading layer axis.  SSM states are exact under padding
        (dt-masked identity steps); attention cache rows past a row's length
        hold padding that the decode-side validity mask never reads.
        ``embeds`` (a stub frontend's output) takes the place of
        ``embed(tokens)``, cast to the config's dtype."""
        cfg = self.cfg
        if embeds is None:
            x = self.embed(params, tokens)
        else:
            x = embeds.to(DTYPES[cfg.dtype])
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        eps = cfg.norm_eps
        caches = []
        for lp in self._blocks(params):
            if cfg.arch_type in BLOCK_TYPES:
                a, c = _attn_prefill(lp["attn"], cfg, rmsnorm(x, lp["ln1"], eps), positions,
                                     self.kv_hint)
                x = self._ffn_residual(lp, x + settle(a))
            elif cfg.arch_type == "ssm":
                y, c = ssm_mod.ssm_prefill(lp, cfg, rmsnorm(x, lp["ln"], eps), lengths)
                x = x + settle(y)
            else:  # hybrid superblock: Mamba2 sublayers, then the shared attention
                c = {}
                for j in range(cfg.shared_attn_every):
                    mp = lp[f"mamba_{j}"]
                    y, c[f"mamba_{j}"] = ssm_mod.ssm_prefill(
                        mp, cfg, rmsnorm(x, mp["ln"], eps), lengths
                    )
                    x = x + settle(y)
                shared = params["shared_attn"]
                a, c["attn"] = _attn_prefill(
                    shared, cfg, rmsnorm(x, shared["ln"], eps), positions, self.kv_hint
                )
                x = x + settle(a)
            caches.append(c)
        cache = {f"dense_{i}": caches[i] for i in range(self.n_dense)}
        cache["layers"] = _stack(caches[self.n_dense:])
        if lengths is None:
            last = x[:, -1:]
        else:
            last = x[torch.arange(B, device=x.device), lengths.long() - 1][:, None, :]
        return self.logits(params, last), cache

    # ----------------------------------------------------------------- decode --
    def _layer_cache(self, batch: int, device: torch.device, attn_cache) -> Params:
        """One layer's (or superblock's) decode cache; ``attn_cache`` makes
        the attention part (flat or paged)."""
        cfg = self.cfg
        dtype = DTYPES[cfg.dtype]
        if cfg.arch_type in BLOCK_TYPES:
            return attn_cache()
        if cfg.arch_type == "ssm":
            return ssm_mod.ssm_init_cache(cfg, batch, dtype, device)
        c = {
            f"mamba_{j}": ssm_mod.ssm_init_cache(cfg, batch, dtype, device)
            for j in range(cfg.shared_attn_every)
        }
        c["attn"] = attn_cache()
        return c

    def _stacked_cache(self, batch: int, device: torch.device, attn_cache) -> Params:
        """Every block's cache: one tree per unrolled ``dense_{i}`` block,
        then the ``layers`` stack."""
        out = {f"dense_{i}": attn_cache() for i in range(self.n_dense)}
        out["layers"] = _repeat_stacked(self._layer_cache(batch, device, attn_cache), self.depth)
        return out

    def init_cache(self, batch: int, max_len: int, device: Device = "cuda") -> Params:
        dev = resolve_device(device)
        return self._stacked_cache(
            batch, dev, lambda: _attn_init_cache(self.cfg, batch, max_len, dev)
        )

    def cache_specs(
        self, seq_axis: Optional[str] = None, dp: Optional[Tuple[str, ...]] = None
    ) -> Params:
        """The decode cache's partition specs, in :meth:`init_cache`'s tree
        (the stacked leaves with a leading ``None``): batch over ``dp``
        (default: the mesh's data axes), attention rows over ``seq_axis``,
        SSM heads over "model"."""
        cfg = self.cfg
        dp = batch_spec(self.mesh_axes) if dp is None else dp

        def with_layer(tree):
            return {k: with_layer(v) if isinstance(v, dict) else (None,) + v
                    for k, v in tree.items()}

        make = attn.mla_cache_specs if cfg.attention_kind == "mla" else attn.gqa_cache_specs
        a_specs = make(cfg, dp, seq_axis)
        if cfg.arch_type in BLOCK_TYPES:
            out = {f"dense_{i}": a_specs for i in range(self.n_dense)}
            out["layers"] = with_layer(a_specs)
            return out
        if cfg.arch_type == "ssm":
            return {"layers": with_layer(ssm_mod.ssm_cache_specs(cfg, dp))}
        sb = {f"mamba_{i}": ssm_mod.ssm_cache_specs(cfg, dp)
              for i in range(cfg.shared_attn_every)}
        sb["attn"] = a_specs
        return {"layers": with_layer(sb)}

    def decode_step(
        self, params: Params, cache: Params, token: torch.Tensor, pos
    ) -> Tuple[torch.Tensor, Params]:
        """One ragged decode step against the flat cache.

        token: (B, 1) int; pos: (B,) per-slot positions — each slot's next
        cache index (== its current context length) — or a scalar.
        ``pos[b] < 0`` marks an idle slot: its logits are still computed
        but it writes nothing to the cache.  Returns (logits, cache)."""
        return self._decode(params, cache, token, pos, paged=False)

    # ------------------------------------------------------------- paged KV --
    @property
    def supports_paged_kv(self) -> bool:
        cfg = self.cfg
        return (
            cfg.arch_type != "ssm"
            and cfg.attention_kind == "gqa"
            and not cfg.sliding_window
        )

    def init_paged_cache(
        self, batch: int, num_pages: int, page_size: int, max_pages: int,
        device: Device = "cuda",
    ) -> Params:
        """Per-layer page pools (one page id addresses a slab across all
        attention layers), the hybrid's SSM states beside them, plus the
        batch's page tables, which the engine refreshes from its
        :class:`~repro_torch.serving.paged_cache.PagePool` before each step."""
        cfg = self.cfg
        if not self.supports_paged_kv:
            raise ValueError(
                f"paged KV unsupported for {cfg.name}: arch_type={cfg.arch_type!r}, "
                f"attention_kind={cfg.attention_kind!r}, "
                f"sliding_window={cfg.sliding_window!r}"
            )
        dev = resolve_device(device)
        out = {"page_tables": torch.zeros((batch, max_pages), dtype=torch.int32, device=dev)}
        out.update(self._stacked_cache(
            batch, dev,
            lambda: attn.gqa_init_paged_cache(cfg, num_pages, page_size, DTYPES[cfg.dtype], dev),
        ))
        return out

    def decode_step_paged(
        self, params: Params, cache: Params, token: torch.Tensor, pos
    ) -> Tuple[torch.Tensor, Params]:
        """Like :meth:`decode_step` but with attention KV in page pools
        (``cache`` from :meth:`init_paged_cache`)."""
        return self._decode(params, cache, token, pos, paged=True)

    def _decode(self, params, cache, token, pos, paged: bool):
        cfg = self.cfg
        eps = cfg.norm_eps
        B = token.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int64, device=token.device).expand(B)
        # live-slot indices, found once per step: finding them waits for the
        # device, which every layer doing it would turn into one wait a layer
        rows = attn.live_rows(pos >= 0)
        # the full flat cache's prefix mask is the same for every layer:
        # built once per step (a ring cache's comes from each layer's slot_pos)
        valid = None
        if not paged and cfg.arch_type != "ssm":
            kv = cache["layers"].get("attn", cache["layers"])
            if "slot_pos" not in kv:
                rows_of = kv["ckv"] if cfg.attention_kind == "mla" else kv["k"]
                valid = attn.prefix_valid(pos, rows_of.shape[2])
        decode = attn.mla_decode if cfg.attention_kind == "mla" else attn.gqa_decode

        def attend(p, h, lc):
            if paged:
                return attn.gqa_decode_paged(p, cfg, h, lc, cache["page_tables"], pos, rows)[0]
            return decode(p, cfg, h, lc, pos, rows, valid)[0]

        x = self.embed(params, token)
        for lp, lc in zip(self._blocks(params), self._blocks(cache)):
            if cfg.arch_type in BLOCK_TYPES:
                a = attend(lp["attn"], rmsnorm(x, lp["ln1"], eps), lc)
                x = self._ffn_residual(lp, x + settle(a))
            elif cfg.arch_type == "ssm":
                y, _ = ssm_mod.ssm_decode(lp, cfg, rmsnorm(x, lp["ln"], eps), lc, rows)
                x = x + settle(y)
            else:  # hybrid superblock
                for j in range(cfg.shared_attn_every):
                    mp = lp[f"mamba_{j}"]
                    y, _ = ssm_mod.ssm_decode(
                        mp, cfg, rmsnorm(x, mp["ln"], eps), lc[f"mamba_{j}"], rows
                    )
                    x = x + settle(y)
                shared = params["shared_attn"]
                x = x + settle(attend(shared, rmsnorm(x, shared["ln"], eps), lc["attn"]))
        return self.logits(params, x), cache

    # ------------------------------------------------------ prefill scatter --
    def scatter_prefill(
        self,
        cache: Params,
        prefill_cache: Params,
        slot: int,
        length: int,
        page_ids: Optional[Sequence[int]] = None,
    ) -> Params:
        """Scatter a batch-1 :meth:`prefill` cache into slot ``slot`` of an
        engine batch cache (flat :meth:`init_cache` layout, or paged
        :meth:`init_paged_cache` layout when ``page_ids`` — the slot's pages,
        covering >= ``length`` tokens — is given), in place.  ``length`` is
        the true prompt length; padding rows past it are never copied, and
        fixed-shape SSM leaves (conv tail, state) are copied whole."""
        return _scatter_node(cache, prefill_cache, slot, length, False, page_ids)


# -- prefill-scatter helpers (admit path) -------------------------------------


def _scatter_leaf(eng, pre, slot, length, stacked):
    """Copy one batch-1 prefill leaf into an engine cache leaf at ``slot``.
    Leaves whose sequence axis differs from the prefill's padded length copy
    only the first ``length`` rows."""
    b = 1 if stacked else 0
    s = b + 1
    if eng.dim() > s and eng.shape[s] != pre.shape[s]:
        if stacked:
            eng[:, slot, :length] = pre[:, 0, :length]
        else:
            eng[slot, :length] = pre[0, :length]
    elif stacked:
        eng[:, slot] = pre[:, 0]
    else:
        eng[slot] = pre[0]
    return eng


def _scatter_pages(pool, pre, page_ids, length, stacked):
    """Scatter the first ``length`` prefill k/v rows into the slot's pages:
    token t lands in (page_ids[t // page_size], t % page_size)."""
    ps = pool.shape[2 if stacked else 1]
    t = torch.arange(length, device=pool.device)
    pi = torch.as_tensor(list(page_ids), dtype=torch.int64, device=pool.device)[t // ps]
    off = t % ps
    if stacked:
        pool[:, pi, off] = pre[:, 0, :length]
    else:
        pool[pi, off] = pre[0, :length]
    return pool


def _scatter_node(eng, pre, slot, length, stacked, page_ids):
    if isinstance(eng, dict):
        out = {}
        for key, sub in eng.items():
            if key == "page_tables":
                out[key] = sub  # refreshed by the engine
            elif key == "pool_k":
                out[key] = _scatter_pages(sub, pre["k"], page_ids, length, stacked)
            elif key == "pool_v":
                out[key] = _scatter_pages(sub, pre["v"], page_ids, length, stacked)
            else:
                out[key] = _scatter_node(
                    sub, pre[key], slot, length, stacked or key == "layers", page_ids
                )
        return out
    return _scatter_leaf(eng, pre, slot, length, stacked)
