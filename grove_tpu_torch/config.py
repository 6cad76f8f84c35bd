"""Model / training configuration dataclasses.

A copy of `grove_tpu/config.py`, so that the port imports nothing of the JAX
package; `tests/test_torch_misc.py` holds the two equal.

Mirrors the hyper-parameter surface of the reference stack
(`grove_transformers/grove_transformers/configuration_grove.py:4-54`,
`model/SAM/build_sam.py:57-113`, CLIP ViT-L/336) but as frozen dataclasses so
every config is hashable and usable as a jit static argument.

Everything is shape-static: the ragged structures of the reference (variable
phrase counts, per-frame box lists) are replaced by fixed maxima + masks, so
`max_phrases` and `max_seq_len` appear here as first-class model dimensions.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT vision tower (reference: openai/clip-vit-large-patch14-336).

    The video adapters follow the reference's vendored copy
    (`model/llava/model/multimodal_encoder/modeling_clip.py:591-636`):
    a zero-init-gated Conv3d adapter after every `adapter_every`-th encoder
    layer (layers with index % adapter_every == 0), operating on the patch
    tokens reshaped to (b, c, t, adapter_h, adapter_w).

    Note the reference reshapes 576 patch tokens with h=16 (=> w=36) even
    though the ViT-L/336 grid is 24x24 (`modeling_clip.py:604`); we reproduce
    that exact reshape for checkpoint parity (the conv is 'same'-padded so any
    factorization type-checks; numerics follow the reference's choice).
    """

    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    adapter_every: int = 3
    adapter_h: int = 16          # reference quirk: fixed h=16 in the rearrange
    num_frames: int = 8
    # Which hidden_states layer feeds the LLM (reference mm_vision_select_layer=-2)
    select_layer: int = -2
    # W8A8 int8 serving mode (see SamEncoderConfig.quant_w8a8): encoder
    # Dense kernels int8 + dynamic per-token activation quant. Patch
    # embedding, adapters and norms stay bf16/f32.
    quant_w8a8: bool = False
    # Static calibrated per-tensor activation scales instead of the
    # dynamic per-token absmax (requires `ops.quant.install_act_scales`
    # after a calibration pass) — removes the per-site full-tensor
    # reduce + f32 materialization from the serving path.
    quant_static_act: bool = False
    # Dispatch the one-pass Pallas LayerNorm->int8 kernel at the static
    # quant sites (see ops/fused_ln.py dispatch note: measured per-tower
    # — a fusion barrier on CLIP, a win where XLA's reduce underruns).
    quant_ln_kernel: bool = False

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_adapters(self) -> int:
        return self.num_layers // self.adapter_every

    @classmethod
    def tiny(cls) -> "ClipVisionConfig":
        return cls(image_size=28, patch_size=14, hidden_size=32,
                   intermediate_size=64, num_layers=3, num_heads=4,
                   adapter_every=3, adapter_h=2, num_frames=2)

    @classmethod
    def small(cls) -> "ClipVisionConfig":
        return cls(image_size=224, patch_size=14, hidden_size=512,
                   intermediate_size=2048, num_layers=8, num_heads=8,
                   adapter_every=3, adapter_h=16, num_frames=8)


@dataclass(frozen=True)
class SamEncoderConfig:
    """SAM ViT image (grounding) encoder — ViTDet-style windowed ViT.

    Reference: `model/SAM/modeling/image_encoder.py` + `build_sam.py:57-113`
    (ViT-H: 1280 dim, 32 layers, window 14, global attention at [7,15,23,31],
    decomposed rel-pos, 256-dim conv neck). GROVE runs it at 512 input
    (32x32 token grid) with a gated Conv3d adapter after each global block.
    """

    img_size: int = 512
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    use_rel_pos: bool = True
    layer_norm_eps: float = 1e-6
    num_frames: int = 8
    # Positional embeddings are stored for this grid (1024-image pretraining);
    # the 512-native build keeps them at the run grid, matching the
    # grove_transformers package (`grove_transformers/.../build_sam.py:66`).
    pretrain_img_size: int = 512
    # W8A8 int8 serving mode: block Dense kernels stored int8 with
    # per-output-channel scales (ops/quant.quantize_sam_tree) AND
    # activations dynamically quantized per token — the encoder is
    # compute-bound, and int8 x int8 MXU dots run 2.0x bf16 on v5e.
    # Patchify, neck, adapters, norms and rel-pos stay bf16/f32.
    quant_w8a8: bool = False
    # Static calibrated per-tensor activation scales (see
    # ClipVisionConfig.quant_static_act).
    quant_static_act: bool = False
    # One-pass Pallas LayerNorm->int8 at the static quant sites (see
    # ClipVisionConfig.quant_ln_kernel / ops/fused_ln.py).
    quant_ln_kernel: bool = False

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @classmethod
    def tiny(cls) -> "SamEncoderConfig":
        return cls(img_size=32, patch_size=16, embed_dim=32, depth=2,
                   num_heads=4, out_chans=16, window_size=2,
                   global_attn_indexes=(1,), num_frames=2)

    @classmethod
    def small(cls) -> "SamEncoderConfig":
        return cls(img_size=256, patch_size=16, embed_dim=384, depth=6,
                   num_heads=6, out_chans=256, window_size=8,
                   global_attn_indexes=(2, 5), num_frames=8,
                   pretrain_img_size=256)


@dataclass(frozen=True)
class SamDecoderConfig:
    """SAM prompt encoder + two-way transformer + GROVE box/objectness heads.

    Reference: `model/SAM/modeling/prompt_encoder.py`, `transformer.py`,
    `mask_decoder.py` with decoding_type="query" — 2-layer TwoWayTransformer
    at 256 dim, 8 heads, mlp 2048, attention downsample rate 2; the query
    (text) token after the transformer feeds a 256->256->4 sigmoid box head
    and a 256->1 objectness head (`mask_decoder.py:80-87,191-203`).
    """

    embed_dim: int = 256
    depth: int = 2
    num_heads: int = 8
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3        # legacy mask tokens kept for parity
    input_image_size: int = 512
    image_embedding_size: int = 32        # 512/16 grid for dense PE
    mask_in_chans: int = 16
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    use_temp_objectness: bool = True

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1

    @classmethod
    def tiny(cls) -> "SamDecoderConfig":
        return cls(embed_dim=16, depth=2, num_heads=2, mlp_dim=32,
                   input_image_size=32, image_embedding_size=2)


@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA-style decoder-only LM (reference: LLaMA-7B-class via HF).

    `extra_vocab_size` covers the GROVE special tokens appended by
    `resize_token_embeddings` (reference `train.py:124-159`):
    <vid_start> <vid_end> <bbox> <point> [DET] <p> </p>.
    """

    vocab_size: int = 32000
    extra_vocab_size: int = 7
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    # LoRA on q/v projections (reference `train.py:336-359`, r=0 disables)
    lora_r: int = 0
    lora_alpha: float = 16.0
    # weight-only int8 serving mode: Dense kernels stored int8 with
    # per-output-channel scales (ops/quant.py); halves LLM weight HBM so
    # the full 8.4B model fits ONE v5e chip
    weight_quant: bool = False
    # W8A8 on top of weight_quant: dynamically quantize activations per
    # token so LLM matmuls run as int8 x int8 MXU dots (2x bf16 rate on
    # v5e). Helps compute-bound prefill; decode (HBM-bound on the int8
    # weights) is unchanged. Requires weight_quant. Adds per-token
    # quantization noise on top of W8A16 — serving opt-in.
    act_quant: bool = False
    # weight-quant bit width: 8 (per-output-channel int8, the default) or
    # 4 (group-wise int4, `ops/quant.quantize_llama_tree_int4`). int4
    # halves weight HBM again (6.7 -> 3.4 GB at 7B) — decode is weight-
    # read-bound, so the decode step speeds up nearly proportionally —
    # at the cost of group-RTN quantization noise and bf16-rate prefill
    # (the int4 path has no W8A8 prefill mode). lm_head stays int8.
    weight_quant_bits: int = 8
    # input-dim group size for int4 scales (GPTQ-class convention)
    quant_group: int = 128
    # decode-path projection fusion: q/k/v -> one (D, 3D) matmul and
    # gate/up -> one (D, 2I) matmul. Bit-identical numerics (output
    # columns are independent dot products); fewer, wider matmuls keep
    # the MXU busier at decode's tiny row counts. Params come from
    # `models.fuse.fuse_llama_projections` (checkpoints stay unfused).
    fused_qkv: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        return self.vocab_size + self.extra_vocab_size

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=128, extra_vocab_size=7, hidden_size=32,
                   intermediate_size=64, num_layers=2, num_heads=4,
                   num_kv_heads=4, max_position_embeddings=512)

    @classmethod
    def small(cls) -> "LlamaConfig":
        return cls(vocab_size=32000, extra_vocab_size=7, hidden_size=768,
                   intermediate_size=2048, num_layers=6, num_heads=12,
                   num_kv_heads=12, max_position_embeddings=2048)


@dataclass(frozen=True)
class SpecialTokenIds:
    """Token-id registry for GROVE special tokens.

    The reference captures these from the tokenizer at startup
    (`train.py:154-158`); we carry them explicitly so the model layer never
    needs a tokenizer object. `video_token_index` is the splice sentinel
    (IMAGE_TOKEN_INDEX = -200, `utils/utils.py:10`).
    """

    # ids follow the reference registration order on a 32000 base vocab
    # (`train.py:124-152`): <vid_start> <vid_end> <bbox> <point> [DET] <p> </p>
    det: int = 32004
    bop: int = 32005              # <p>
    eop: int = 32006              # </p>
    bbox: int = 32002
    point: int = 32003
    vid_start: int = 32000
    vid_end: int = 32001
    pad: int = 0
    bos: int = 1
    eos: int = 2
    unk: int = 0
    video_token_index: int = -200
    ignore_index: int = -100


@dataclass(frozen=True)
class GroveConfig:
    """Top-level config tying the four sub-networks together.

    Static-shape knobs (`max_phrases`, `max_seq_len`) replace the reference's
    ragged per-sample structures. `num_video_tokens` is the pooled CLIP video
    token count (8x8x9 = 576, `pooling.py:13`), so the splice offset of the
    reference (`model/GROVE.py:200-205`: 575) is `num_video_tokens - 1` here.
    """

    clip: ClipVisionConfig = dataclasses.field(default_factory=ClipVisionConfig)
    sam_enc: SamEncoderConfig = dataclasses.field(default_factory=SamEncoderConfig)
    sam_dec: SamDecoderConfig = dataclasses.field(default_factory=SamDecoderConfig)
    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    tokens: SpecialTokenIds = dataclasses.field(default_factory=SpecialTokenIds)

    num_frames: int = 8
    pool_t: int = 8
    pool_h: int = 8
    pool_w: int = 9
    max_phrases: int = 16
    max_seq_len: int = 1536        # token budget before video-splice expansion
    out_dim: int = 256             # text_hidden_fcs output = SAM prompt dim
    use_temp_objectness: bool = True
    temp_objectness_threshold: float = 0.5
    # Reference quirk (`clip_encoder.py:55` @torch.no_grad): CLIP tower
    # output is detached, so its adapters — though marked trainable by the
    # freeze policy (`train.py:234-334`) — receive zero gradient. Default
    # preserves that; True lifts the stop_gradient so CLIP-adapter
    # training is real.
    train_clip_adapters: bool = False
    ce_loss_weight: float = 1.0
    giou_loss_weight: float = 1.0
    temp_objectness_loss_weight: float = 1.0
    with_region: bool = True

    @property
    def num_video_tokens(self) -> int:
        return self.pool_t * self.pool_h * self.pool_w

    @property
    def splice_offset(self) -> int:
        """Extra sequence length added by replacing <video> with video tokens."""
        return self.num_video_tokens - 1

    @property
    def spliced_seq_len(self) -> int:
        return self.max_seq_len + self.splice_offset

    @classmethod
    def tiny(cls) -> "GroveConfig":
        clip = ClipVisionConfig.tiny()
        return cls(
            clip=clip,
            sam_enc=SamEncoderConfig.tiny(),
            sam_dec=SamDecoderConfig.tiny(),
            llama=LlamaConfig.tiny(),
            # ids follow MockTokenizer (base vocab 128 + GROVE_EXTRA_TOKENS
            # in registration order)
            tokens=SpecialTokenIds(vid_start=128, vid_end=129, bbox=130,
                                   point=131, det=132, bop=133, eop=134,
                                   pad=0, bos=1, eos=2, unk=0),
            num_frames=clip.num_frames,
            pool_t=clip.num_frames, pool_h=2, pool_w=2,
            max_phrases=4,
            max_seq_len=160,
            out_dim=16,
        )

    @classmethod
    def small(cls) -> "GroveConfig":
        """Structurally-complete scaled-down flagship for single-chip
        compile checks and benchmarking (full 7B-class weights don't exist
        in this environment)."""
        return cls(
            clip=ClipVisionConfig.small(),
            sam_enc=SamEncoderConfig.small(),
            sam_dec=SamDecoderConfig(input_image_size=256,
                                     image_embedding_size=16),
            llama=LlamaConfig.small(),
            tokens=SpecialTokenIds(vid_start=32000, vid_end=32001,
                                   bbox=32002, point=32003, det=32004,
                                   bop=32005, eop=32006),
            num_frames=8,
            pool_t=8, pool_h=8, pool_w=9,
            max_phrases=16,
            max_seq_len=512,
            out_dim=256,
        )

    # ------------------------------------------------------------------
    # JSON round-trip (grove_transformers `GroveConfig` is an HF config
    # serialized as config.json, `configuration_grove.py:4-54`)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GroveConfig":
        sub = {"clip": ClipVisionConfig, "sam_enc": SamEncoderConfig,
               "sam_dec": SamDecoderConfig, "llama": LlamaConfig,
               "tokens": SpecialTokenIds}
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if f.name in sub:
                fields = {x.name for x in dataclasses.fields(sub[f.name])}
                v = sub[f.name](**{k: (tuple(x) if isinstance(x, list) else x)
                                   for k, x in v.items() if k in fields})
            kw[f.name] = v
        return cls(**kw)

    def save_json(self, path: str) -> None:
        import json
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def load_json(cls, path: str) -> "GroveConfig":
        import json
        with open(path) as f:
            return cls.from_dict(json.load(f))
