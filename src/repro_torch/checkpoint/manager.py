"""Fault-tolerant checkpoints (port of repro/checkpoint/manager.py): atomic
step directories, keep-k GC, integer tables (codes + Delta) saved as they
are, per-leaf crc32, and the reference's on-disk protocol.

Layout (the reference's, byte for byte in the protocol):
  <dir>/step_000000120/
    manifest.json       # step, leaf index (path, file, dtype, shape, crc32),
                        # tree structure, embedding-method metadata
    leaf_00000.npy ...  # one np.save'd array per leaf (int8 codes stay int8)
  <dir>/step_000000120.COMMITTED   # empty marker written LAST

A tree is nested dicts (keys sorted), lists, tuples and NamedTuples over
tensors, numpy arrays and Python scalars (ints saved as int32, the
reference's dtype), with a ``CodeStore`` as its ``.data`` bytes and a
serving table as its ``tree_children()`` by flat index, as the reference's
pytree registry flattens them; :func:`flatten` gives each leaf a path
spelled as ``jax.tree_util.keystr`` spells it (``.field``, ``['key']``,
``[i]``, ``[<flat index i>]``), so the leaves of a port checkpoint line up,
path for path, with the reference's of the same state.  ``treedef`` holds the port's own plain
description of the structure (:func:`describe`).  Tensors are saved from the
card with ``.cpu()`` after one synchronize; a restore puts every leaf on the
``device`` the caller names (``cuda`` by default), dtype kept (int8 codes,
packed uint8, prune's bool mask), in the tree rebuilt from the paths
(:func:`unflatten_paths`: attributes and dict keys as dict keys, indices as
lists); the trainers' ``restore`` turn it into their states, and a
restore given the config's ``spec`` refuses another config's table before
any array loads.

Re-sharding (``CheckpointManager.restore(shardings=)``): the files hold
whole leaves, so a restore cuts each rank's shard for the mesh it runs on
(``repro_torch.dist.sharding.shard_tree``), whatever mesh saved them; a
save from shards gathers them first and rank 0 writes
(``training.lm_trainer.save``).

Observability, as the reference's: a save is one ``ckpt.save`` span and a
restore one ``ckpt.restore`` span; the registry counts ``ckpt.saves``,
``ckpt.restores`` and ``ckpt.corrupt_refused`` (a restore refused on
verification).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
import os
import pathlib
import re
import shutil
import tempfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import methods
from repro_torch.core import codestore
from repro_torch.methods import layout
from repro_torch.obs import counters as obs_counters
from repro_torch.obs.trace import tracer
from repro_torch.optim import OptState, adam_init, tree_leaves, tree_like
from repro_torch.serving import table as serving_tbl


#: Bytes that hold any ``.npy`` header the port writes (format 1.0 allows 64 KiB).
_HEADER_MAX = 1 << 17

_REG = obs_counters.registry()
_MET_SAVES = _REG.counter("ckpt.saves", "checkpoints written")
_MET_RESTORES = _REG.counter("ckpt.restores", "checkpoints restored")
_MET_CORRUPT = _REG.counter("ckpt.corrupt_refused", "restores refused on verification failure")


class CorruptCheckpointError(RuntimeError):
    """A committed artifact failed checksum/parse verification on restore."""


# ------------------------------------------------------------------ trees


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children_by_flat_index(x) -> bool:
    """A serving table: the reference registers it with anonymous children."""
    return hasattr(x, "tree_children")


def flatten(tree) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's flatten order: dict keys sorted, sequences
    and NamedTuple fields in order, a ``CodeStore`` its bytes alone (bits,
    geometry and packing are static, recorded in ``embedding_storage``), a
    serving table its children, ``None`` no leaf."""
    out = []

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}[{k!r}]")
        elif _is_namedtuple(x):
            for name, v in zip(x._fields, x):
                walk(v, f"{path}.{name}")
        elif isinstance(x, codestore.CodeStore):
            walk(x.data, f"{path}.data")
        elif _children_by_flat_index(x):
            for i, v in enumerate(x.tree_children()):
                walk(v, f"{path}[<flat index {i}>]")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        else:
            out.append((path, x))

    walk(tree, "")
    return out


_KEY = re.compile(r"\.(\w+)|\['([^']*)'\]|\[<flat index (\d+)>\]|\[(\d+)\]")


def path_keys(path: str) -> list:
    """The keys of a leaf path, whatever its spelling: ``.a['b'][0]`` and
    ``['a']['b'][<flat index 0>]`` both give ``['a', 'b', 0]``."""
    keys, pos = [], 0
    while pos < len(path):
        m = _KEY.match(path, pos)
        if m is None:
            raise ValueError(f"unparseable leaf path {path!r}")
        attr, key, flat, idx = m.groups()
        if attr is not None or key is not None:
            keys.append(attr if attr is not None else key)
        else:
            keys.append(int(flat if flat is not None else idx))
        pos = m.end()
    return keys


def unflatten_paths(pairs) -> Any:
    """The tree of ``[(path, leaf)]`` rebuilt from the paths alone: a
    NamedTuple field or dict key becomes a dict key, an index a list slot
    (a list slot without a leaf, ``None``)."""
    root: dict = {}
    for path, leaf in pairs:
        keys = path_keys(path)
        if not keys:
            return leaf
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def listify(x):
        if not isinstance(x, dict):
            return x
        x = {k: listify(v) for k, v in x.items()}
        if x and all(isinstance(k, int) for k in x):
            return [x.get(i) for i in range(max(x) + 1)]  # a slot with no leaf was None
        return x

    return listify(root)


def describe(tree) -> str:
    """The structure of ``tree`` in a line: NamedTuples by name and field,
    dicts and sequences as literals, each leaf ``*``."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{n}={describe(v)}" for n, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, codestore.CodeStore):
        return "CodeStore(data=*)"
    if _children_by_flat_index(tree):
        return type(tree).__name__ + "(" + ", ".join(
            describe(v) for v in tree.tree_children()) + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(describe(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(describe(v) for v in tree) + ")"
    return "*"


def _scalar(leaf):
    """A Python int as the reference holds it, an int32 scalar."""
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.int32(leaf)
    return leaf


def leaf_shape(leaf) -> tuple[int, ...]:
    """The shape of a tensor, array or scalar leaf."""
    if isinstance(leaf, torch.Tensor):
        return tuple(int(s) for s in leaf.shape)
    return tuple(int(s) for s in np.shape(leaf))


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(_scalar(leaf)).dtype)


def schema_of(tree) -> dict:
    """Leaf path -> ``{"shape", "dtype"}`` of ``tree``."""
    return {path: {"shape": list(leaf_shape(leaf)), "dtype": _dtype_name(leaf)}
            for path, leaf in flatten(tree)}


def checkpoint_schema(spec) -> dict:
    """Leaf path -> ``{shape, dtype}`` of the method's state for ``spec``
    (``EmbeddingMethod.checkpoint_schema``): what a manifest records so
    that int8 codes restore as int8, and a restore can refuse another
    geometry before any array loads."""
    return methods.get(spec.method).checkpoint_schema(spec)


def serving_template(spec) -> serving_tbl.ServingTable:
    """The serving-resident table of ``spec`` (the method's
    ``serving_state``: codes + Delta for integer tables) on the ``meta``
    device, from a state of :func:`checkpoint_schema`'s shapes: no memory,
    no kernel.  A serving restore checks the artifact's leaves against it
    and reads them into it (``from_tree``)."""
    method = methods.get(spec.method)
    if type(method).serving_state is methods.EmbeddingMethod.serving_state:
        # the default export: the fp32 [n, d] evaluation table
        return serving_tbl.FloatTable(torch.empty(spec.n, spec.d, device="meta"))
    leaves = [(path, torch.empty(s["shape"], dtype=getattr(torch, s["dtype"]), device="meta")
               if s["shape"] else 1) for path, s in checkpoint_schema(spec).items()]
    state = layout.emb_state_from_numpy(spec, unflatten_paths(leaves), device="meta")
    return method.serving_state(state, dataclasses.replace(spec, use_kernels=False))


# ----------------------------------------------------------- manifests


def config_hash(cfg: Any) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def embedding_storage(spec: Any) -> dict:
    """Code-container layout for a manifest: whether codes are stored packed
    (sub-byte widths share bytes), how many codes ride per resident byte, and
    the bit layout, so a restore can refuse a packed artifact under an
    unpacked config (same logical shapes, different bytes) and vice versa."""
    packed = bool(getattr(spec, "packed", True)) and codestore.is_packable(spec.bits)
    return {
        "bits": spec.bits,
        "packed": packed,
        "codes_per_byte": codestore.codes_per_byte(spec.bits) if packed else 1,
        "layout": "low-bits-first",
    }


def embedding_manifest(spec: Any) -> dict:
    """The embedding keys of a manifest: the method's name, capability
    flags, leaf schema and code container layout."""
    return {
        "embedding_method": spec.method,
        "embedding_capabilities": methods.get(spec.method).capabilities(),
        "embedding_schema": checkpoint_schema(spec),
        "embedding_storage": embedding_storage(spec),
    }


def check_embedding_manifest(manifest: dict, spec: Any) -> list[str]:
    """Mismatches between a manifest and ``spec`` (empty: compatible, or no
    embedding metadata recorded)."""
    saved = manifest.get("embedding_method")
    if saved is None:
        return []
    problems = []
    if saved != spec.method:
        problems.append(f"checkpoint embedding method {saved!r} != configured {spec.method!r}")
        return problems  # another method's schema says nothing more
    schema = checkpoint_schema(spec)
    if manifest.get("embedding_schema", schema) != schema:
        problems.append("embedding table schema differs (shape/dtype/leaves)")
    storage = embedding_storage(spec)
    if manifest.get("embedding_storage", storage) != storage:
        problems.append("embedding storage layout differs (bits/packing/container)")
    return problems


def _refuse_mismatch(what: str, problems: list[str]) -> None:
    if problems:
        raise ValueError(f"{what} refused — checkpoint/config mismatch: " + "; ".join(problems))


# ------------------------------------------------------------ save / load


def _fsync(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    arr = np.asarray(_scalar(leaf))
    return arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)


def _write_leaf(path: pathlib.Path, arr: np.ndarray) -> int:
    """``np.save`` ``arr`` (C order) to ``path``, fsync'd; returns the crc32
    of the file's bytes, header included, taken over the header and the
    array's memory (the data are not read back)."""
    with open(path, "wb") as f:
        np.lib.format.write_array(f, arr, allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())
    with open(path, "rb") as f:
        crc = zlib.crc32(f.read(os.path.getsize(path) - arr.nbytes))
    return zlib.crc32(arr.reshape(-1).view(np.uint8), crc)


def save_pytree(tree, directory: str | os.PathLike, *, step: int,
                extra_meta: dict | None = None) -> pathlib.Path:
    """Atomic save: write to a temp dir, fsync, rename, then the marker."""
    with tracer().span("ckpt.save", step=step):
        out = _save_pytree(tree, directory, step=step, extra_meta=extra_meta)
    _MET_SAVES.inc()
    return out


def _save_pytree(tree, directory: str | os.PathLike, *, step: int,
                 extra_meta: dict | None) -> pathlib.Path:
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f".tmp_step_{step:09d}_", dir=directory))
    flat = flatten(tree)
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda for _, leaf in flat):
        torch.cuda.synchronize()
    index = []
    for i, (path, leaf) in enumerate(flat):
        arr = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        # The checksum covers the file as written, header included, so any
        # flipped bit on disk fails restore verification.
        index.append({"path": path, "file": fname, "dtype": str(arr.dtype),
                      "shape": list(arr.shape), "crc32": _write_leaf(tmp / fname, arr)})
    manifest = {"step": step, "leaves": index, "treedef": describe(tree), **(extra_meta or {})}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    _fsync(tmp / "manifest.json")
    _fsync(tmp)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic on POSIX
    _fsync(directory)
    (directory / f"step_{step:09d}.COMMITTED").touch()
    _fsync(directory)
    return final


def _read_leaf(path: pathlib.Path, entry: dict, verify: bool) -> np.ndarray:
    """The array of a leaf file, read once: the crc32 over the bytes read,
    then the array a view of them past the ``.npy`` header."""
    raw = np.empty(os.path.getsize(path), np.uint8)
    with open(path, "rb") as f:
        f.readinto(raw)
    if verify and "crc32" in entry:
        crc = zlib.crc32(raw)
        if crc != entry["crc32"]:
            raise CorruptCheckpointError(
                f"{path}: crc32 {crc:#010x} != manifest {entry['crc32']:#010x}")
    try:
        header = io.BytesIO(raw[:_HEADER_MAX].tobytes())
        major, _ = np.lib.format.read_magic(header)
        read = (np.lib.format.read_array_header_1_0 if major == 1
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(header)
        count = math.prod(shape)
        arr = np.frombuffer(raw, dtype=dtype, count=count, offset=header.tell())
        if header.tell() + count * dtype.itemsize != raw.size:
            raise ValueError(f"{raw.size} bytes for {count} x {dtype} after the header")
        return arr.reshape(shape, order="F" if fortran else "C")
    except (ValueError, OSError, EOFError) as err:
        raise CorruptCheckpointError(f"{path}: unreadable leaf: {err}") from err


def load_pytree(directory: str | os.PathLike, *, step: int | None = None,
                device: str | torch.device = "cuda", verify: bool = True, spec: Any = None):
    """Restore ``step`` (the newest committed by default) -> ``(tree, manifest)``.

    Every leaf goes to ``device`` with its dtype, in the tree rebuilt from
    the paths (:func:`unflatten_paths`).  ``verify`` checks each file
    against its crc32 and raises
    :class:`CorruptCheckpointError` on a mismatch or an unparseable leaf:
    a corrupted checkpoint is refused, never half-loaded.  Given the
    config's embedding ``spec``, a manifest whose method, schema or packing
    disagrees with it (:func:`check_embedding_manifest`) raises
    ``ValueError`` before any array loads.
    """
    with tracer().span("ckpt.restore", step=-1 if step is None else step):
        try:
            out = _load_pytree(directory, step=step, device=device, verify=verify, spec=spec)
        except CorruptCheckpointError:
            _MET_CORRUPT.inc()
            raise
    _MET_RESTORES.inc()
    return out


def _load_pytree(directory, *, step: int | None, device, verify: bool, spec: Any):
    dev = device_mod.resolve(device)
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = directory / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if spec is not None:
        _refuse_mismatch("restore", check_embedding_manifest(manifest, spec))
    pairs = [(e["path"], torch.from_numpy(_read_leaf(d / e["file"], e, verify)).to(dev))
             for e in manifest["leaves"]]
    return unflatten_paths(pairs), manifest


def latest_step(directory: str | os.PathLike) -> int | None:
    """The newest step with a commit marker and a manifest (an uncommitted
    directory is invisible)."""
    steps = _committed(pathlib.Path(directory))
    return steps[-1] if steps else None


def _committed(directory: pathlib.Path) -> list[int]:
    return sorted(int(m.stem.split("_")[1]) for m in directory.glob("step_*.COMMITTED")
                  if (directory / m.stem / "manifest.json").exists())


# --------------------------------------------------------------- serving


def save_serving_checkpoint(directory: str | os.PathLike, *, step: int, params: Any,
                            table: Any, spec: Any) -> pathlib.Path:
    """Serving export: the dense / transformer params + the serving-resident
    table.  ``table`` is a method state (converted through ``serving_state``)
    or a serving table; either way the artifact holds inference state only:
    codes + Delta for integer tables, never an fp32 table, never an
    optimizer slot.  The manifest carries :func:`embedding_manifest`."""
    if not serving_tbl.is_serving_table(table):
        table = methods.get(spec.method).serving_state(table, spec)
    return save_pytree({"params": params, "table": table}, directory, step=step,
                       extra_meta=embedding_manifest(spec))


def restore_serving_checkpoint(directory: str | os.PathLike, spec: Any, *,
                               step: int | None = None, device: str | torch.device = "cuda"):
    """``(params, serving_table, manifest)`` from a serving checkpoint.

    A manifest whose method, schema or packing disagrees with ``spec``, or
    whose table leaves are not :func:`serving_template`'s, is refused before
    any array loads.  Codes restore as they were saved, read into the
    template and straight into residency; ``params`` is the nested dict /
    list tree of the paths."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    manifest = json.loads((directory / f"step_{step:09d}" / "manifest.json").read_text())
    problems = check_embedding_manifest(manifest, spec)
    template = serving_template(spec)
    have = {e["path"]: {"shape": e["shape"], "dtype": e["dtype"]} for e in manifest["leaves"]
            if e["path"].startswith("['table']")}
    if not problems and have != schema_of({"table": template}):
        problems.append("serving table leaves differ from the method's serving template")
    _refuse_mismatch("serving restore", problems)
    tree, manifest = load_pytree(directory, step=step, device=device)
    table = template.from_tree(tree["table"], use_kernels=spec.use_kernels)
    return tree["params"], table, manifest


# ------------------------------------------------------- training states


def check_table(tree, spec: Any) -> None:
    """Refuse a restored table whose leaves (paths and shapes) are not the
    config's (:func:`checkpoint_schema`) before converting any: another
    method, width, packing or padding, also where a manifest records no
    embedding metadata."""
    def keyed(pairs):
        return {tuple(path_keys(p)): list(shape) for p, shape in pairs}

    have = keyed((p, leaf_shape(leaf)) for p, leaf in flatten(tree))
    want = keyed((p, s["shape"]) for p, s in checkpoint_schema(spec).items())
    if have != want:
        raise ValueError(
            f"checkpoint table has {len(have)} leaves, the config's {spec.method!r} table "
            f"{len(want)} — config mismatch? missing {sorted(set(want) - set(have))[:4]}, "
            f"unexpected {sorted(set(have) - set(want))[:4]}, shapes differ at "
            f"{sorted(k for k in set(have) & set(want) if have[k] != want[k])[:4]}")


def opt_tree(opt: OptState | None, like):
    """An Adam ``OptState`` as a checkpoint holds it: ``mu`` / ``nu`` laid
    out as ``like`` (a tree of the parameters, or a function of the moment
    list)."""
    if opt is None:
        return None
    shape = like if callable(like) else (lambda leaves: tree_like(like, leaves))
    return OptState(step=opt.step, mu=shape(opt.mu), nu=shape(opt.nu))


def opt_from_tree(tree: dict | None, params: list, moments) -> OptState:
    """The ``OptState`` over ``params`` of a restored ``{"step", "mu",
    "nu"}`` (``moments`` turns a moment tree into a tensor list); zeros when
    ``tree`` is None."""
    if tree is None:
        return adam_init(params)
    return OptState(step=int(tree["step"]), mu=moments(tree["mu"]), nu=moments(tree["nu"]))


def float_leaves(tree, dev) -> list[torch.Tensor]:
    """A tree's leaves as fp32 tensors on ``dev``."""
    return [layout.as_tensor(a, torch.float32, dev) for a in tree_leaves(tree)]


def reference_generator_seed(seed: int, step: int) -> int:
    """The seed of the generator a reference checkpoint resumes with: the
    config's ``seed`` and the checkpoint's step, ``seed * 2^32 + step``
    modulo 2^63.  Its draws are torch's, not the reference's: a resume from
    a reference checkpoint matches the reference step for step only when the
    reference's noise (and dropout masks) are handed to ``train_step``."""
    return (int(seed) * 2**32 + int(step)) % 2**63


def generator_from_tree(tree: dict, seed: int, step: int, dev) -> torch.Generator:
    """The saved ``generator`` leaf's generator on ``dev``, or for a
    reference checkpoint (no such leaf: its threefry ``rng`` cannot cross)
    one seeded with :func:`reference_generator_seed`."""
    generator = torch.Generator(device=dev)
    if "generator" in tree:
        generator.set_state(tree["generator"].cpu())
    else:
        generator.manual_seed(reference_generator_seed(seed, step))
    return generator


# --------------------------------------------------------------- manager


class CheckpointManager:
    """Keep-k checkpoint rotation + resume + preemption save."""

    def __init__(self, directory: str | os.PathLike, *, keep: int = 3, save_every: int = 100):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.save_every = save_every
        # Steps refused by restore verification (newest-first fallback walk).
        self.corrupt_steps: list[int] = []

    def should_save(self, step: int) -> bool:
        """Whether the cadence saves ``step``: every ``save_every``-th, never 0."""
        return step != 0 and step % self.save_every == 0

    def maybe_save(self, tree, step: int, *, force: bool = False,
                   extra_meta: dict | None = None) -> bool:
        """Save at every ``save_every``-th step (never step 0) or when forced."""
        if not (force or self.should_save(step)):
            return False
        save_pytree(tree, self.directory, step=step, extra_meta=extra_meta)
        self._gc()
        return True

    def restore(self, step: int | None = None, device: str | torch.device = "cuda", *,
                spec: Any = None, shardings=None):
        """``(tree, manifest)`` of ``step`` (a corrupted artifact refused
        loudly) or, with ``step=None``, of the newest committed checkpoint
        that passes verification: corrupted ones are skipped, recorded in
        ``corrupt_steps``, and the walk falls back to the last good one.
        Given ``spec``, another config's table is refused, not skipped
        (:func:`load_pytree`).  ``shardings`` = ``(specs, mesh)``: each leaf
        is cut to this rank's shard under its spec (a spec tree laid out as
        the saved tree, ``repro_torch.dist.sharding.shard_tree``)."""
        if shardings is not None:
            from repro_torch.dist import sharding

            tree, manifest = self.restore(step, device, spec=spec)
            return sharding.shard_tree(tree, *shardings), manifest
        if step is not None:
            return load_pytree(self.directory, step=step, device=device, spec=spec)
        steps = _committed(self.directory)[::-1]
        if not steps:
            raise FileNotFoundError(f"no committed checkpoint in {self.directory}")
        last_err: CorruptCheckpointError | None = None
        for s in steps:
            try:
                return load_pytree(self.directory, step=s, device=device, spec=spec)
            except CorruptCheckpointError as err:
                last_err = err
                self.corrupt_steps.append(s)
                print(f"[checkpoint] step {s} refused ({err}); "
                      "falling back to previous committed checkpoint")
        raise CorruptCheckpointError(
            f"all {len(steps)} committed checkpoints in {self.directory} failed verification"
        ) from last_err

    def read_manifest(self, step: int) -> dict:
        """The manifest alone (no array loads), for pre-restore checks."""
        return json.loads((self.directory / f"step_{step:09d}" / "manifest.json").read_text())

    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def _gc(self) -> None:
        steps = sorted(int(m.stem.split("_")[1]) for m in self.directory.glob("step_*.COMMITTED"))
        for s in steps[: -self.keep] if self.keep else []:
            # Marker first: a crash between the two leaves an uncommitted
            # (invisible) directory, never a committed-but-missing one.
            (self.directory / f"step_{s:09d}.COMMITTED").unlink(missing_ok=True)
            shutil.rmtree(self.directory / f"step_{s:09d}", ignore_errors=True)
