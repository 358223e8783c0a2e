"""Render-state checkpoint and resume (the JAX package's
``utils/checkpoint.py``).

The progressive state (accum, spp, seed) is the whole render, and the RNG
is counter based over global sample ids, so a resumed render equals an
uninterrupted one bit for bit. The file is the JAX package's: one .npz
with ``accum`` (H, W, 3) f32, ``spp`` () i32, ``seed`` () u32 and the
config fingerprint, sha256 of the config's fields as sorted JSON. The
port's ``RenderConfig`` has the JAX field names and defaults, so one
config has one fingerprint in both packages and either package resumes
the other's file. A different config (resolution, seed, engine...) is
refused.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from pathtracing_tpu_torch.models.progressive import RenderState
from pathtracing_tpu_torch.utils.config import RenderConfig, resolve_device


def config_fingerprint(config: RenderConfig) -> str:
    payload = json.dumps(dataclasses.asdict(config), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save(path: str, state: RenderState, config: RenderConfig) -> None:
    """Write ``state`` atomically: a temporary file, then ``os.replace``.
    The accumulator is copied to the host before this returns, so the
    caller may go on updating it in place."""
    tmp = path + ".tmp.npz"    # np.savez appends .npz to other names
    np.savez(
        tmp,
        accum=state.accum.detach().cpu().numpy(),
        spp=np.int32(state.spp),
        seed=np.uint32(state.seed),
        fingerprint=np.frombuffer(
            config_fingerprint(config).encode(), dtype=np.uint8),
    )
    os.replace(tmp, path)


def load(path: str, config: RenderConfig, device=None) -> RenderState:
    """The state in ``path`` on ``device`` (the card unless the caller asks
    for another device); ValueError if it was written with another
    config."""
    device = resolve_device(device)
    with np.load(path) as data:
        stored = bytes(data["fingerprint"]).decode()
        want = config_fingerprint(config)
        if stored != want:
            raise ValueError(
                f"checkpoint {path} was written with a different config "
                f"(fingerprint {stored} != {want}); refusing to resume"
            )
        return RenderState(
            accum=torch.as_tensor(np.array(data["accum"], np.float32),
                                  device=device),
            spp=int(data["spp"]),
            seed=int(data["seed"]),
        )
