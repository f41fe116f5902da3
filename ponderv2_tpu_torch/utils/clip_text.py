"""CLIP text embeddings for semantic render supervision and PPT heads.

A copy of ``ponderv2_tpu/utils/clip_text.py`` with only the import lines
changed (see ``datasets/transform.py`` for why it is a copy). The reference
PonderV2 loads a frozen CLIP ViT-B/16 at model construction and encodes the
class-name prompts once (its ``ponder_indoor_base.py``). Here embeddings are
produced on the host, once, by (in priority order):

1. a precomputed ``.npy`` file (``embedding_path``) — the recommended offline
   route (no torch/network in the training job);
2. HuggingFace ``transformers`` CLIPTextModelWithProjection if its weights are
   locally cached;
3. a deterministic random fallback (unit-norm, seeded from class names) so the
   pipeline runs end-to-end in asset-free environments — clearly logged.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Sequence

import numpy as np

from .logger import get_root_logger

CLIP_DIM = 512
_DEFAULT_TEMPLATE = "a photo of a {} in a scene"
_CACHE = {}


def _fallback_embeddings(class_names: Sequence[str], dim: int) -> np.ndarray:
    out = np.zeros((len(class_names), dim), np.float32)
    for i, name in enumerate(class_names):
        seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
        rng = np.random.RandomState(seed)
        v = rng.randn(dim).astype(np.float32)
        out[i] = v / np.linalg.norm(v)
    return out


_ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "clip_text",
)


def _find_committed_asset(class_names: Sequence[str]) -> Optional[str]:
    """Committed embedding file whose meta class list matches exactly
    (tools/export_clip_embeddings.py writes <vocab>.npy + <vocab>.meta.json)."""
    if not os.path.isdir(_ASSETS_DIR):
        return None
    import json

    for name in sorted(os.listdir(_ASSETS_DIR)):
        if not name.endswith(".meta.json"):
            continue
        try:
            with open(os.path.join(_ASSETS_DIR, name)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue
        if tuple(meta.get("classes", ())) == tuple(class_names):
            npy = os.path.join(_ASSETS_DIR, name[: -len(".meta.json")] + ".npy")
            if os.path.isfile(npy):
                return npy
    return None


def get_text_embeddings(
    class_names: Sequence[str],
    template: str = _DEFAULT_TEMPLATE,
    embedding_path: Optional[str] = None,
    clip_model: str = "openai/clip-vit-base-patch16",
    dim: int = CLIP_DIM,
) -> np.ndarray:
    """(num_classes, dim) float32 unit-norm text embeddings. Cached per call
    signature (flax setup() re-runs on every apply; the encode must not)."""
    key = (tuple(class_names), template, embedding_path, clip_model, dim)
    if key in _CACHE:
        return _CACHE[key]
    logger = get_root_logger()
    if not embedding_path:
        # committed per-vocabulary assets (assets/clip_text/) resolve by exact
        # class-list match, so every standard vocabulary loads without config
        # plumbing; see assets/clip_text/README.md for stub vs real provenance
        embedding_path = _find_committed_asset(class_names)
        if embedding_path:
            logger.info(f"CLIP text embeddings from {embedding_path}")
    if embedding_path and os.path.isfile(embedding_path):
        emb = np.load(embedding_path).astype(np.float32)
        assert emb.shape[0] == len(class_names), (
            f"{embedding_path} has {emb.shape[0]} rows for {len(class_names)} classes"
        )
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
        _CACHE[key] = emb
        return emb
    try:
        from transformers import CLIPTextModelWithProjection, CLIPTokenizer
        import torch

        tokenizer = CLIPTokenizer.from_pretrained(clip_model, local_files_only=True)
        model = CLIPTextModelWithProjection.from_pretrained(
            clip_model, local_files_only=True
        )
        model.eval()
        prompts = [template.format(n) for n in class_names]
        with torch.no_grad():
            tokens = tokenizer(prompts, padding=True, return_tensors="pt")
            emb = model(**tokens).text_embeds.numpy().astype(np.float32)
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
        _CACHE[key] = emb
        return emb
    except Exception as e:  # no cached weights / no network
        logger.warning(
            f"CLIP text encoder unavailable ({type(e).__name__}); using "
            f"deterministic random embeddings. Provide embedding_path for real "
            f"CLIP supervision."
        )
        emb = _fallback_embeddings(class_names, dim)
        _CACHE[key] = emb
        return emb
