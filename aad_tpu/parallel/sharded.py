"""Multi-chip scaling: sharded batch decode/encode over a device mesh.

The codec's parallel structure (SURVEY.md §2.3): block x channel decode
tasks are fully independent (every block header carries complete state,
reference: src/aad_decoder.c:363-380), and encode chains state per stream
but is independent *across* streams. The scaling story is therefore pure
data/sequence parallelism:

* **decode**: the flattened lane axis (streams x blocks x channels) shards
  over the whole mesh — "dp" over streams, "sp" over the block (sequence)
  axis. No collectives are required on the hot path; each shard runs the
  fused kernel locally under ``shard_map``.
* **encode**: streams shard over "dp"; each device scans its streams'
  blocks sequentially. The only cross-device op is an optional ``psum``
  for global quality statistics.
* **sequence-parallel encode**: in the block-independent mode
  (ops.encode.encode_blocks_parallel) even ONE stream's block axis shards
  over the whole mesh — impossible for the bit-exact sequential encoder,
  whose state chains across blocks.

Tensor/pipeline/expert parallelism have no profitable mapping for a 4-tap
codec (SURVEY.md §2.3 table) — the mesh is used purely for throughput
scaling, which is exactly what the format admits.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..ops.decode import _decode_blocks_impl, resolve_engine

Array = jax.Array


def make_mesh(
    n_devices: int | None = None,
    axis_names=("dp", "sp"),
    shape: tuple[int, int] | None = None,
) -> Mesh:
    """Build a (dp, sp) mesh over the first ``n_devices`` devices.

    dp spans streams, sp spans the block/sequence axis. By default the
    factorisation puts the larger factor on dp (streams are the coarser
    unit); pass ``shape=(dp, sp)`` to pin it.
    """
    devs = jax.devices()
    if shape is not None:
        dp, sp = shape
        n = n_devices or dp * sp
        if dp * sp != n:
            raise ValueError(f"mesh shape {shape} does not cover {n} devices")
        if len(devs) < n:
            raise ValueError(
                f"make_mesh: requested {n} devices but only {len(devs)} "
                "available"
            )
        return Mesh(np.array(devs[:n]).reshape(dp, sp), axis_names)
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"make_mesh: requested {n} devices but only {len(devs)} available "
            f"({devs[0].platform}). For a virtual CPU mesh set "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n} and force "
            "the cpu platform before JAX backend init."
        )
    devs = devs[:n]
    sp = 1
    for cand in (2, 4):
        if n % cand == 0 and n // cand >= cand:
            sp = cand
    dp = n // sp
    arr = np.array(devs).reshape(dp, sp)
    return Mesh(arr, axis_names)


def _pad_axis0(x: Array, multiple: int) -> tuple[Array, int]:
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
    return x, n


def decode_blocks_sharded(
    codes: Array,
    step_index: Array,
    weight: Array,
    history: Array,
    *,
    bits_per_sample: int,
    mesh: Mesh,
    engine: str = "auto",
) -> Array:
    """Decode a flattened lane batch with lanes sharded over the whole mesh.

    Args:
      codes: (L, T); step_index: (L,); weight/history: (L, 4).
    Returns:
      (L, T + FILTER_ORDER) samples, lane-sharded over the mesh.
    """
    engine = resolve_engine(engine)
    total = mesh.size
    spec = P(("dp", "sp"))

    codes, L = _pad_axis0(codes, total)
    step_index, _ = _pad_axis0(step_index, total)
    weight, _ = _pad_axis0(weight, total)
    history, _ = _pad_axis0(history, total)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    def _local(c, si, w, h):
        return _decode_blocks_impl(
            c, si, w, h, bits_per_sample=bits_per_sample, engine=engine
        )

    out = jax.jit(_local)(codes, step_index, weight, history)
    return out[:L]


def encode_blocks_parallel_sharded(
    blocks: Array,
    valid: Array,
    *,
    bits_per_sample: int,
    num_trials: int,
    mesh: Mesh,
    chunk_blocks: int = 1,
    warm_passes: int = 0,
):
    """Sequence-parallel encode of ONE stream over the whole mesh.

    Block-independent mode (ops.encode.encode_blocks_parallel): every block
    encodes from a fresh state, so the **block axis itself** shards over
    (dp x sp) with zero hot-path collectives — the encode-side counterpart
    of decode_blocks_sharded, and a sharding the bit-exact sequential
    encoder cannot admit (its state chains across blocks, reference:
    src/aad_encoder.c:870).

    The quality knobs compose with the mesh: ``chunk_blocks``/
    ``warm_passes`` (see ops.encode.encode_blocks_parallel) — the block
    axis is padded to a multiple of ``mesh.size * chunk_blocks`` so shard
    boundaries always fall on chunk boundaries, and between warm passes
    each shard hands its last chunk's final chain state to the next shard
    with a ring ``ppermute`` (the mesh's one hot-path collective).
    Sharded output is therefore **bit-identical to the unsharded
    call for every (chunk_blocks, warm_passes)** — pinned by
    tests/test_sharding.py.

    Args:
      blocks: (B, C, nspb) int32 zero-padded (MS already applied).
      valid:  (B,) int32 valid sample counts.
    Returns:
      (headers, kernel words (B, C, Wk)).
    """
    from ..ops.encode import (
        BlockHeaderFields,
        encode_blocks_parallel,
        encode_stream_words,
        parallel_warm_states,
        shift_chunk_states,
    )

    c = max(int(chunk_blocks), 1)
    total = mesh.size * c
    spec = P(("dp", "sp"))
    blocks, B = _pad_axis0(blocks, total)
    valid, _ = _pad_axis0(valid, total)
    n_shards = mesh.size
    ring = [(i, i + 1) for i in range(n_shards - 1)]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(
            BlockHeaderFields(
                step_index=spec, shift=spec, weight=spec, history=spec
            ),
            spec,
        ),
        check_vma=False,
    )
    def _local(bl, va):
        if warm_passes == 0:
            return encode_blocks_parallel(
                bl, va, bits_per_sample, num_trials, chunk_blocks=c,
            )
        B_loc = bl.shape[0]
        G = B_loc // c

        def to_chunks(x):
            return jnp.swapaxes(x.reshape(G, c, *x.shape[1:]), 0, 1)

        def from_chunks(x):
            return jnp.swapaxes(x, 0, 1).reshape(B_loc, *x.shape[2:])

        xs = to_chunks(bl)
        vs = to_chunks(va[:, None])
        warm = c > 1
        carry = None
        for _ in range(warm_passes):
            st = parallel_warm_states(
                xs, vs, bits_per_sample, carry=carry, warm_on_prev=warm,
            )
            # ring handoff: this shard's last-chunk state seeds the next
            # shard's first chunk (shard 0 stays a stream head — ppermute
            # delivers zeros to non-receivers), making the sharded warm
            # pass bit-identical to the unsharded one.
            last = jax.tree.map(lambda x: x[-1], st)
            head = jax.tree.map(
                lambda x: jax.lax.ppermute(x, ("dp", "sp"), ring), last
            )
            carry = (
                shift_chunk_states(st, head=head),
                jnp.zeros_like(xs[0]),
            )
        headers, kw, _ = encode_stream_words(
            xs, vs, bits_per_sample, num_trials,
            warm_on_prev=warm, need_carry=False, carry=carry,
        )
        return jax.tree.map(from_chunks, headers), from_chunks(kw)

    headers, words = jax.jit(_local)(blocks, valid)
    trim = lambda x: x[:B]
    return jax.tree.map(trim, headers), words[:B]


def encode_streams_sharded(
    blocks: Array,
    valid: Array,
    *,
    bits_per_sample: int,
    num_trials: int,
    mesh: Mesh,
    stat: bool = False,
):
    """Encode a batch of independent streams, sharded over every mesh axis.

    Args:
      blocks: (S, B, C, nspb) zero-padded per-stream block tensors
        (MS already applied); valid: (S, B) per-block sample counts.
      stat: opt into the mesh-global quality statistic. It costs a full
        decode of every emitted block on every call (roughly doubling the
        encode), so the default is off — throughput callers get pure
        encode speed; QA callers pass ``stat=True``.
    Returns:
      (headers, codes) with a leading sharded stream axis, plus — with
      ``stat=True`` — the mesh-global full-scale-normalised reconstruction
      RMSE (each shard decodes its own emitted codes back and the squared
      error is psum'd — the same statistic as the reference CLI's -c mode,
      reference: src/main.c:441-503, computed across the whole mesh).
      With ``stat=False`` the third element is None.
    """
    from ..ops.decode import _decode_blocks_impl
    from ..ops.encode import encode_stream_blocks

    total = mesh.size
    spec = P(("dp", "sp"))
    blocks, S = _pad_axis0(blocks, total)
    valid, _ = _pad_axis0(valid, total)
    nspb = blocks.shape[-1]

    out_specs = (spec, spec, P()) if stat else (spec, spec)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=out_specs,
        check_vma=False,
    )
    def _local(bl, va):
        headers, codes = jax.vmap(
            lambda b, v: encode_stream_blocks(b, v, bits_per_sample, num_trials)
        )(bl, va)
        if not stat:
            return headers, codes
        # Global quality telemetry: decode the emitted codes back with the
        # emitted headers (block self-containedness makes this exact) and
        # psum the squared reconstruction error over the whole mesh.
        recon = _decode_blocks_impl(
            codes.astype(jnp.uint8),
            headers.step_index,
            headers.weight,
            headers.history,
            bits_per_sample=bits_per_sample,
            engine="scan",
        )  # (s, B, C, nspb)
        err = (recon - bl).astype(jnp.float32) * (1.0 / 32768.0)
        live = (
            jnp.arange(nspb, dtype=jnp.int32)[None, None, None, :]
            < va[..., None, None]
        )
        local_sse = jnp.sum(jnp.where(live, err * err, 0.0))
        local_cnt = jnp.sum(
            jnp.broadcast_to(live, err.shape).astype(jnp.float32)
        )
        gsse = jax.lax.psum(local_sse, ("dp", "sp"))
        gcnt = jax.lax.psum(local_cnt, ("dp", "sp"))
        return headers, codes, jnp.sqrt(gsse / jnp.maximum(gcnt, 1.0))

    out = jax.jit(_local)(blocks, valid)
    headers, codes = out[0], out[1]
    quality = out[2] if stat else None
    trim = lambda x: x[:S]
    return jax.tree.map(trim, headers), codes[:S], quality
