#!/usr/bin/env python
"""Memory-safety fuzz of the native codec under AddressSanitizer + UBSan.

The native C++ engine (aad_tpu/native/aadx.cc) serves one-shot encode()/
decode() auto-routing, the CLI, and CPU-only hosts — a crash or OOB there
is a production incident, so this tool pins memory safety the way
tools/soak_fuzz.py pins conformance:

* **Parent** builds a sanitizer libaadx (``-fsanitize=address,undefined
  -fno-sanitize-recover=all -O1 -g -fwrapv``), precomputes per-seed
  expected artifacts with the production library (sha256 of encode bytes,
  parallel-encode bytes and decoded samples — guarding against a
  sanitizer-build miscompile), then re-execs this script as a **child**
  under ``LD_PRELOAD=libasan.so`` with ``AAD_TPU_NATIVE_LIB`` pointing at
  the sanitizer build (the loader override in aad_tpu/native/__init__.py).

* A second ASan pass re-runs the same manifest-checked child with
  ``AADX_FORCE_SCALAR=1`` (the dispatch-gate knob in aadx.cc): on an
  AVX-512 host the scalar engine otherwise runs only as tail drains, so
  this pass is the proof that the full scalar-as-main-path configuration
  — the reference's entire codec — is memory-safe AND byte-identical to
  the SIMD path over every fuzz geometry (the manifest hashes came from
  the production SIMD build).

* A **ThreadSanitizer phase** rebuilds libaadx with
  ``-fsanitize=thread`` and drives the threaded batch entry points
  (encode_batch sequential + parallel-mode, decode_batch) over an
  8-worker pool, asserting byte-identity with the single-threaded calls —
  executable evidence for the "stateless per call, GIL-free thread pool"
  concurrency claim (aad_tpu/native/__init__.py::encode_batch).

* **Child** drives every exported entry point over random geometries —
  parse_header, decode, encode, encode_parallel (chunk/warm knobs),
  encode_chunk (streaming carry, asserting the concatenation reproduces
  the one-shot bytes), decode_payload_blocks — then mutation-fuzzes the
  decoder: byte flips, span rewrites, truncations, extensions, zeroed
  spans and pure-random buffers must either decode or raise a codec
  error, never trip a sanitizer. ``-fno-sanitize-recover=all`` makes any
  finding abort the child, so the parent's exit-code check is the proof.

The reference decoder walks block data with DEBUG-only asserts
(/root/reference/src/aad_decoder.c:394-455); the native engine instead
bounds-checks every read (aadx.cc decode gates) — this tool is the
executable evidence that those gates hold under adversarial input.

Usage:
    python tools/run_sanitizer_fuzz.py [seeds] [mutations_per_stream] \
        [--record PATH]

Defaults: 120 seeds, 40 mutations per kept stream (~2 min). ``--record``
writes a JSON artifact for the round's audit trail. Exit 0 iff the child
survived every call with expected-hash agreement.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SEED_BASE = 90_000  # disjoint from the suite's (1000+) and the soak's (50000+)
MUT_KEEP = 6        # streams kept per seed-run for the mutation phase


def _geometry(rng):
    """Random stream geometry, the soak's distribution (odd sizes, MS, trials)."""
    import numpy as np

    nch = int(rng.integers(1, 3))
    bps = int(rng.integers(2, 5))
    mbs = int(rng.integers(40 * nch, 1200))
    ms = int(rng.integers(0, 2)) if nch == 2 else 0
    trials = int(rng.integers(0, 3))
    from aad_tpu import EncodeConfig

    cfg = EncodeConfig(
        num_channels=nch, sampling_rate=8000, bits_per_sample=bps,
        max_block_size=mbs, ch_process_method=ms, num_encode_trials=trials,
    )
    nspb = cfg.geometry().num_samples_per_block
    n = int(rng.integers(1, 5 * nspb + 2))
    scale = [32768, 32768, 8192, 512][n % 4]
    pcm = rng.integers(-scale, scale, (nch, n)).astype(np.int32)
    return cfg, pcm


def _seed_streams(seed: int):
    """Deterministic per-seed work items: (cfg, pcm, chunk_blocks, warm)."""
    import numpy as np

    rng = np.random.default_rng(SEED_BASE + seed)
    cfg, pcm = _geometry(rng)
    cb = int(rng.integers(1, 4))
    wp = int(rng.integers(0, 3))
    return rng, cfg, pcm, cb, wp


def _run_seed(seed: int, native) -> dict:
    """Encode/decode a seed through every native entry point; return hashes."""
    import numpy as np

    rng, cfg, pcm, cb, wp = _seed_streams(seed)

    enc = native.encode(pcm, cfg)
    hdr, dec = native.decode(enc)
    par = native.encode_parallel(pcm, cfg, chunk_blocks=cb, warm_passes=wp)
    _, pdec = native.decode(par)

    # streaming carry: whole-block chunks concatenate to the one-shot bytes
    nspb = cfg.geometry().num_samples_per_block
    state, prev = native.stream_state(cfg)
    parts, done, bi = [], 0, 0
    while done < pcm.shape[1]:
        nblk = int(rng.integers(1, 4))
        take = min(nblk * nspb, pcm.shape[1] - done)
        parts.append(
            native.encode_chunk(pcm[:, done:done + take], cfg, state, prev, bi)
        )
        bi += -(-take // nspb)
        done += take
    from aad_tpu.constants import FILE_HEADER_SIZE

    chunked = b"".join(parts)
    if chunked != enc[FILE_HEADER_SIZE:]:
        raise AssertionError(f"seed {seed}: chunked payload != one-shot tail")

    # headerless block decode of the payload span
    geo_bs = hdr.block_size
    payload = np.frombuffer(enc, dtype=np.uint8)[FILE_HEADER_SIZE:]
    nblocks = -(-hdr.num_samples // hdr.num_samples_per_block)
    pad = np.zeros(nblocks * geo_bs - payload.size, dtype=np.uint8)
    blk = native.decode_payload_blocks(
        np.concatenate([payload, pad]), hdr, hdr.num_samples
    )
    if not np.array_equal(blk, dec):
        raise AssertionError(f"seed {seed}: decode_payload_blocks != decode")

    h = lambda b: hashlib.sha256(b).hexdigest()[:16]
    return {
        "enc": h(enc), "par": h(par),
        "dec": h(np.ascontiguousarray(dec).tobytes()),
        "pdec": h(np.ascontiguousarray(pdec).tobytes()),
    }


def _mutate(rng, data: bytes) -> bytes:
    """One adversarial mutation of a valid stream."""
    import numpy as np

    buf = bytearray(data)
    kind = int(rng.integers(0, 6))
    if kind == 0 and buf:  # flip random bits
        for _ in range(int(rng.integers(1, 33))):
            i = int(rng.integers(0, len(buf)))
            buf[i] ^= 1 << int(rng.integers(0, 8))
    elif kind == 1 and buf:  # rewrite a random span
        a = int(rng.integers(0, len(buf)))
        b = min(len(buf), a + int(rng.integers(1, 64)))
        buf[a:b] = rng.integers(0, 256, b - a, dtype=np.uint8).tobytes()
    elif kind == 2:  # truncate
        buf = buf[: int(rng.integers(0, len(buf) + 1))]
    elif kind == 3:  # extend with garbage
        buf += rng.integers(0, 256, int(rng.integers(1, 257)),
                            dtype=np.uint8).tobytes()
    elif kind == 4 and buf:  # zero a span
        a = int(rng.integers(0, len(buf)))
        b = min(len(buf), a + int(rng.integers(1, 128)))
        buf[a:b] = bytes(b - a)
    else:  # pure random buffer
        buf = bytearray(
            rng.integers(0, 256, int(rng.integers(0, 4097)),
                         dtype=np.uint8).tobytes()
        )
    return bytes(buf)


def _child(n_seeds: int, mutations: int, manifest_path: str) -> int:
    from aad_tpu import native
    from aad_tpu.codec.result import AadError

    lib_env = os.environ.get("AAD_TPU_NATIVE_LIB", "")
    assert lib_env and native.available(), "sanitizer lib failed to load"
    manifest = json.loads(Path(manifest_path).read_text())

    import numpy as np

    kept: list[bytes] = []
    for seed in range(n_seeds):
        got = _run_seed(seed, native)
        want = manifest[str(seed)]
        if got != want:
            print(f"MISCOMPILE? seed={seed}: sanitizer build {got} != "
                  f"production {want}")
            return 1
        if (len(kept) < MUT_KEEP
                and seed % max(1, n_seeds // MUT_KEEP) == 0):
            _, cfg, pcm, _, _ = _seed_streams(seed)
            kept.append(native.encode(pcm, cfg))

    mrng = np.random.default_rng(SEED_BASE - 1)
    n_mut = ok_mut = err_mut = 0
    for base in kept:
        for _ in range(mutations):
            mut = _mutate(mrng, base)
            n_mut += 1
            try:
                native.decode(mut)  # parse_header + full decode gates
                ok_mut += 1
            except (AadError, RuntimeError):
                err_mut += 1

    # headerless block-walk fuzz: garbage payload spans through the bounds
    # gates of aadx_decode_blocks under a VALID geometry (the streaming
    # decoder's entry — adversarial network chunks land here)
    hdr0, _ = native.decode(kept[0])
    for _ in range(mutations):
        nb = int(mrng.integers(1, 9))
        span = mrng.integers(0, 256, nb * hdr0.block_size, dtype=np.uint8)
        try:
            native.decode_payload_blocks(
                span, hdr0,
                min(hdr0.num_samples, nb * hdr0.num_samples_per_block),
            )
        except (AadError, RuntimeError):
            pass

    print(json.dumps({
        "child": "done", "seeds": n_seeds, "streams_mutated": len(kept),
        "mutations": n_mut, "decoded_ok": ok_mut, "raised": err_mut,
    }))
    return 0


def _tsan_child(n_seeds: int) -> int:
    """Threaded batch calls under TSan: races abort, bytes must match."""
    import numpy as np

    from aad_tpu import native

    assert os.environ.get("AAD_TPU_NATIVE_LIB") and native.available()
    for seed in range(n_seeds):
        rng, cfg, pcm, cb, wp = _seed_streams(seed)
        streams = [pcm] + [
            rng.integers(-32768, 32768, pcm.shape).astype(np.int32)
            for _ in range(7)
        ]
        encs = native.encode_batch(streams, cfg, max_workers=8)
        pencs = native.encode_batch(
            streams, cfg, max_workers=8, parallel_blocks=True,
            chunk_blocks=cb, warm_passes=wp,
        )
        if encs != [native.encode(s, cfg) for s in streams]:
            print(f"TSAN-PHASE BYTE DIVERGENCE seed={seed} (sequential)")
            return 1
        if pencs != [
            native.encode_parallel(s, cfg, chunk_blocks=cb, warm_passes=wp)
            for s in streams
        ]:
            print(f"TSAN-PHASE BYTE DIVERGENCE seed={seed} (parallel)")
            return 1
        decs = native.decode_batch(encs, max_workers=8)
        for enc, (_, d) in zip(encs, decs):
            _, ref = native.decode(enc)
            if not np.array_equal(d, ref):
                print(f"TSAN-PHASE BYTE DIVERGENCE seed={seed} (decode)")
                return 1
    print(json.dumps({"tsan_child": "done", "seeds": n_seeds,
                      "streams_per_seed": 8}))
    return 0


def _parent(n_seeds: int, mutations: int, record: str | None) -> int:
    t0 = time.time()
    src = _REPO / "aad_tpu" / "native"
    tmp = Path(tempfile.mkdtemp(prefix="aadx_san"))
    san_lib = tmp / "libaadx_san.so"
    # -O1 keeps ASan's shadow checks on every real access (-O3 can elide
    # reads); -fwrapv matches the production semantics contract.
    cmd = [
        "g++", "-std=c++17", "-O1", "-g", "-fPIC", "-fwrapv",
        "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
        "-shared", "-o", str(san_lib), str(src / "aadx.cc"),
    ]
    subprocess.run(cmd, check=True, timeout=300)

    # expected artifacts from the production library
    from aad_tpu import native

    assert native.available(), "production native lib unavailable"
    manifest = {str(s): _run_seed(s, native) for s in range(n_seeds)}
    manifest_path = tmp / "manifest.json"
    manifest_path.write_text(json.dumps(manifest))

    libasan = subprocess.run(
        ["gcc", "-print-file-name=libasan.so"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    env = dict(os.environ)
    env.update(
        LD_PRELOAD=libasan,
        AAD_TPU_NATIVE_LIB=str(san_lib),
        JAX_PLATFORMS="cpu",
        # python/numpy leak by design; ODR noise from unrelated preloaded
        # libs is not our codec's problem — OOB/UAF/UB all still abort.
        ASAN_OPTIONS="detect_leaks=0:detect_odr_violation=0:abort_on_error=1",
        UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1",
    )
    rc = subprocess.run(
        [sys.executable, __file__, "--child", str(n_seeds), str(mutations),
         str(manifest_path)],
        env=env, timeout=3600,
    ).returncode

    # phase 1b: the same child, scalar path forced at the dispatch gates.
    # The manifest hashes came from the production (SIMD) library, so a
    # clean pass proves the scalar-as-main-path configuration is both
    # memory-safe and byte-identical to SIMD on every fuzz geometry.
    rc_scalar: "int | None" = None  # None = skipped (ASan phase failed)
    if rc == 0:
        senv = dict(env, AADX_FORCE_SCALAR="1")
        rc_scalar = subprocess.run(
            [sys.executable, __file__, "--child", str(n_seeds),
             str(mutations), str(manifest_path)],
            env=senv, timeout=3600,
        ).returncode
        rc = rc_scalar

    # phase 2: ThreadSanitizer over the threaded batch entry points
    tsan_seeds = max(4, n_seeds // 8)
    rc_tsan: "int | None" = None  # None = phase skipped (ASan failed first)
    if rc == 0:
        tsan_lib = tmp / "libaadx_tsan.so"
        subprocess.run(
            ["g++", "-std=c++17", "-O1", "-g", "-fPIC", "-fwrapv",
             "-fsanitize=thread", "-shared", "-o", str(tsan_lib),
             str(src / "aadx.cc")],
            check=True, timeout=300,
        )
        libtsan = subprocess.run(
            ["gcc", "-print-file-name=libtsan.so"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        tenv = dict(os.environ)
        tenv.update(
            LD_PRELOAD=libtsan,
            AAD_TPU_NATIVE_LIB=str(tsan_lib),
            JAX_PLATFORMS="cpu",
            TSAN_OPTIONS="halt_on_error=1",
        )
        rc_tsan = subprocess.run(
            [sys.executable, __file__, "--tsan-child", str(tsan_seeds)],
            env=tenv, timeout=3600,
        ).returncode
        rc = rc_tsan

    result = {
        "seeds": n_seeds,
        "mutation_streams": min(MUT_KEEP, n_seeds),
        "mutations_per_stream": mutations,
        "sanitizers": "address,undefined (no-recover) + thread",
        # null = the scalar-forced pass never ran (SIMD ASan failed first);
        # true = scalar path ASan-clean AND byte-identical to SIMD.
        "scalar_forced_ok": (rc_scalar == 0) if rc_scalar is not None else None,
        "tsan_seeds": tsan_seeds if rc_tsan is not None else 0,
        # null in the record = TSan never ran (the ASan phase failed first),
        # distinct from false = TSan ran and found a race/divergence.
        "tsan_ok": (rc_tsan == 0) if rc_tsan is not None else None,
        "entry_points": [
            "parse_header", "decode", "encode", "encode_parallel",
            "encode_chunk", "decode_payload_blocks",
        ],
        "seconds": round(time.time() - t0, 1),
        "ok": rc == 0,
    }
    print(json.dumps(result))
    if record:
        Path(record).write_text(json.dumps(result, indent=1) + "\n")
    return rc


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv and argv[0] == "--child":
        sys.exit(_child(int(argv[1]), int(argv[2]), argv[3]))
    if argv and argv[0] == "--tsan-child":
        sys.exit(_tsan_child(int(argv[1])))
    rec = None
    if "--record" in argv:
        i = argv.index("--record")
        rec = argv[i + 1]
        del argv[i : i + 2]
    n = int(argv[0]) if argv else 120
    m = int(argv[1]) if len(argv) > 1 else 40
    sys.exit(_parent(n, m, rec))
