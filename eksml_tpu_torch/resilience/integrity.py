"""Checkpoint-integrity manifests and fallback verification (a copy of
``eksml_tpu/resilience/integrity.py``; the port keeps its own so that it
imports nothing of the JAX package).

The checkpoint manager (``utils/checkpoint.py``) commits a step
atomically on POSIX (tmp dir + rename), so a *plain-digit*
``checkpoints/<step>/`` directory is normally whole.  But
the shared filesystem under a training job is NFS/FUSE, where a host
dying mid-flush can rename a directory whose file contents are still
buffered — and operators (or chaos tests) can truncate files directly.
``latest_step()`` alone cannot see any of that; a relaunch that trusts
it crashes in deserialization, turning a transient fault into a
permanent one.

The defense is layered:

1. At save time (after the background commit is known finished) the
   manager writes ``checkpoints/.integrity/<step>.json`` — every
   file's size, and optionally a sha256 digest
   (``RESILIENCE.CHECKPOINT_DIGEST``).
2. At restore time :func:`verify_step` compares the directory against
   its manifest (missing or size/digest-mismatched files → reject;
   unexpected extras are logged, not fatal).  A step
   with *no* manifest (killed between commit and manifest write) only
   gets the structural check — the restore attempt itself is the last
   line of defense and the caller falls back on any exception.
3. Rejected steps are quarantined (renamed ``<step>.corrupt-<n>``) so
   they stop shadowing good steps and a re-run of that step can
   commit cleanly.

All functions take the checkpoints root (``<logdir>/checkpoints``).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

MANIFEST_DIRNAME = ".integrity"


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, str(step))


def manifest_path(root: str, step: int) -> str:
    return os.path.join(root, MANIFEST_DIRNAME, f"{step}.json")


def topology_manifest_path(root: str, step: int) -> str:
    """Topology manifest for a step, next to its integrity manifest
    (``.topology.json`` keeps it out of :func:`list_manifest_steps`'s
    digit namespace)."""
    return os.path.join(root, MANIFEST_DIRNAME, f"{step}.topology.json")


def write_topology_manifest(root: str, step: int, topo: Dict) -> str:
    """Atomically publish the topology descriptor a step was saved on
    (``parallel/topology.py`` dict) — the elastic-resume subsystem's
    evidence for the reshard-vs-trust decision at restore time."""
    from eksml_tpu_torch.parallel import topology

    path = topology_manifest_path(root, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": topology.SCHEMA_VERSION,
                   "topology": topology.normalize(topo)}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # readers see a whole manifest or none
    return path


def read_topology_manifest(root: str, step: int) -> Optional[Dict]:
    """The topology descriptor a step was saved on, or ``None`` when
    the manifest is absent, torn, or from an unknown schema version —
    all three mean "no topology evidence", never an error (pre-elastic
    checkpoints have no manifest and must keep restoring)."""
    from eksml_tpu_torch.parallel import topology

    try:
        with open(topology_manifest_path(root, step)) as f:
            payload = json.load(f)
        if payload.get("version") != topology.SCHEMA_VERSION:
            return None
        return topology.normalize(payload.get("topology"))
    except (OSError, ValueError, AttributeError):
        return None


def _walk_files(step_dir: str) -> List[str]:
    out = []
    for base, _dirs, files in os.walk(step_dir):
        for f in files:
            out.append(os.path.relpath(os.path.join(base, f), step_dir))
    return sorted(out)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def build_manifest(step_dir: str, digest: bool = False) -> Dict:
    files: Dict[str, Dict] = {}
    for rel in _walk_files(step_dir):
        path = os.path.join(step_dir, rel)
        entry: Dict = {"size": os.path.getsize(path)}
        if digest:
            entry["sha256"] = _sha256(path)
        files[rel] = entry
    return {"version": 1, "digest": bool(digest), "files": files}


def write_manifest(root: str, step: int, digest: bool = False) -> str:
    """Build + atomically publish the manifest for a committed step."""
    step_dir = _step_dir(root, step)
    manifest = build_manifest(step_dir, digest=digest)
    path = manifest_path(root, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # readers see a whole manifest or none
    return path


def manifest_readable(root: str, step: int) -> bool:
    """True only when the step's manifest exists AND parses — the
    precondition for treating a later restore failure as systematic
    rather than as corruption (a kill mid-flush can truncate the
    manifest exactly like it truncates the step dir)."""
    try:
        with open(manifest_path(root, step)) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def list_manifest_steps(root: str) -> List[int]:
    d = os.path.join(root, MANIFEST_DIRNAME)
    if not os.path.isdir(d):
        return []
    return sorted(int(p[:-5]) for p in os.listdir(d)
                  if p.endswith(".json") and p[:-5].isdigit())


def prune_manifests(root: str, keep_steps) -> None:
    """Drop manifests for steps the manager garbage-collected
    (max_to_keep)."""
    keep = set(int(s) for s in keep_steps)
    for step in list_manifest_steps(root):
        if step not in keep:
            try:
                os.remove(manifest_path(root, step))
            except OSError:
                pass
    # topology manifests follow the same retention — ONE sweep covers
    # both the pruned steps above and orphans whose integrity manifest
    # never landed (writer died between the two writes)
    d = os.path.join(root, MANIFEST_DIRNAME)
    if os.path.isdir(d):
        for p in os.listdir(d):
            if not p.endswith(".topology.json"):
                continue
            stem = p[:-len(".topology.json")]
            if stem.isdigit() and int(stem) not in keep:
                try:
                    os.remove(os.path.join(d, p))
                except OSError:
                    pass


def verify_step(root: str, step: int,
                check_digest: bool = True) -> Tuple[bool, str]:
    """Is ``checkpoints/<step>/`` safe to hand to the restore?

    Returns ``(ok, reason)``; ``reason`` is a one-line diagnostic for
    the relaunch log.  Without a manifest only structural checks run —
    the caller must still treat a restore exception as "walk back".
    """
    step_dir = _step_dir(root, step)
    if not os.path.isdir(step_dir):
        return False, f"step {step}: directory missing"
    present = _walk_files(step_dir)
    if not present:
        return False, f"step {step}: directory empty"

    mpath = manifest_path(root, step)
    if not os.path.exists(mpath):
        # Committed but the writer died before the manifest landed —
        # cannot prove integrity, but must not reject a likely-good
        # step either (that would discard real progress).
        return True, f"step {step}: no manifest (structural check only)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        expected = manifest["files"]
    except (OSError, ValueError, KeyError) as e:
        return True, f"step {step}: unreadable manifest ({e}); " \
                     "structural check only"

    missing = sorted(set(expected) - set(present))
    if missing:
        return False, (f"step {step}: {len(missing)} file(s) missing "
                       f"vs manifest (e.g. {missing[0]})")
    extra = sorted(set(present) - set(expected))
    if extra:
        # non-fatal: bookkeeping appended after the manifest was built
        # does not endanger the restore
        log.warning("checkpoint step %d has %d file(s) not in its "
                    "manifest (e.g. %s) — ignored", step, len(extra),
                    extra[0])
    for rel, entry in expected.items():
        path = os.path.join(step_dir, rel)

        # An I/O error while *verifying* is evidence about the MOUNT,
        # not the step's bytes: retry the blip (NFS failover, ESTALE)
        # with short backoff.  FileNotFoundError stays un-retried —
        # a manifest-listed file being absent IS corruption evidence.
        # Persistent failure raises (retry_call's RuntimeError): the
        # relaunch crashes and the orchestrator retries later, which
        # preserves the step — quarantining here would let one mount
        # outage destroy every good checkpoint newest-first.
        def check(path=path, entry=entry, rel=rel):
            size = os.path.getsize(path)
            if size != entry["size"]:
                return False, (f"step {step}: {rel} is {size} bytes, "
                               f"manifest says {entry['size']} "
                               "(truncated commit?)")
            if check_digest and "sha256" in entry:
                if _sha256(path) != entry["sha256"]:
                    return False, f"step {step}: {rel} sha256 mismatch"
            return True, ""

        def check_absent_is_evidence():
            # FileNotFoundError is corruption evidence (walk back),
            # never a retryable blip — keep it out of the OSError retry
            try:
                return check()
            except FileNotFoundError:
                return False, (f"step {step}: {rel} vanished during "
                               "verification")

        from eksml_tpu_torch.resilience.retry import retry_call

        ok, why = retry_call(
            check_absent_is_evidence, attempts=3, backoff_sec=0.5,
            retry_on=(OSError,),
            describe=f"verifying checkpoint step {step} file {rel}")
        if not ok:
            return False, why
    return True, f"step {step}: verified against manifest"


def quarantine_step(root: str, step: int) -> Optional[str]:
    """Rename a bad step dir out of the digit namespace so neither
    the manager's step scan nor a later save at the same step trips
    over it.
    Returns the new path (or None if the rename failed — e.g. another
    host already moved it, which is fine)."""
    step_dir = _step_dir(root, step)
    n = 0
    while True:
        target = f"{step_dir}.corrupt-{n}"
        if not os.path.exists(target):
            break
        n += 1
    try:
        os.replace(step_dir, target)
    except OSError as e:
        log.warning("could not quarantine checkpoint step %d: %s",
                    step, e)
        return None
    for path in (manifest_path(root, step),
                 topology_manifest_path(root, step)):
        try:
            os.remove(path)
        except OSError:
            pass
    log.warning("quarantined corrupt checkpoint step %d -> %s",
                step, os.path.basename(target))
    return target
