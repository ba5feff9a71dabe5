"""Crash-safe checkpoint lineage: rotating keep-N generations with an
fsync'd atomic commit protocol and a checksummed MANIFEST (a copy of the
JAX package's ``resilience/manager.py``; the loads take ``device=`` where
the JAX package takes ``mesh=``).  The layout, the manifest's CRC and the
file format are the JAX package's, so a lineage directory written by
either package resumes in the other.

The layout inside a lineage directory:

.. code-block:: text

    MANIFEST.json       {"crc32": C, "body": {"version": 1,
                         "generations": [{"gen", "file", "bytes",
                                          "crc32"}, ...]}}
    gen-000001.dc       checkpoint files (io/checkpoint.py format v2)
    gen-000002.dc
    ...

Commit protocol (the multi-level-checkpointing discipline of Moody et
al., SC'10, scaled to one node):

1. the checkpoint is written to ``gen-NNNNNN.dc.tmp``, fsync'd, and
   atomically renamed (``io/checkpoint.py`` does this);
2. the file is read back and its whole-file CRC32 recorded;
3. the MANIFEST is rewritten (temp + fsync + rename) with the new
   generation appended and generations beyond ``keep`` dropped;
4. only then are rotated-out generation files deleted.

A SIGKILL between any two steps leaves either the old lineage intact or
the new generation fully committed — never a state where the only
checkpoint is torn.  :meth:`CheckpointLineage.latest_valid` scans
generations newest-first, skipping any that are missing, fail the
whole-file CRC, or fail the format's own section/cell CRCs
(``lineage.generations_skipped{reason=...}``); a torn MANIFEST
(``lineage.manifest_torn``) degrades to a directory scan, so even
"SIGKILL mid-manifest-rewrite" loses nothing but metadata.
"""
from __future__ import annotations

import glob
import json
import os
import re
import zlib

from ..io.checkpoint import (
    CheckpointError,
    load_grid_data,
    quick_validate,
    save_grid_data,
)
from . import inject

__all__ = ["CheckpointLineage", "MANIFEST_NAME"]

MANIFEST_NAME = "MANIFEST.json"

_GEN_RE = re.compile(r"^gen-(\d{6,})\.dc$")


def _file_crc(path: str, chunk: int = 1 << 22) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return crc
            crc = zlib.crc32(b, crc)


class CheckpointLineage:
    """Rotating multi-generation checkpoint store in one directory.

    ``keep`` bounds the retained generations (older ones are deleted
    after each successful commit).  The same directory may be reopened
    by any process — generation numbering continues from whatever is on
    disk, whether or not the MANIFEST survived.
    """

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = str(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------ manifest

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def _read_manifest(self):
        """Returns ``(entries, healthy)``: the manifest's generation
        list (oldest first) and whether the manifest itself was intact.
        A missing manifest is healthy-empty; a torn/corrupt one is
        counted (``lineage.manifest_torn``) and reported unhealthy so
        callers fall back to the directory scan."""
        from ..obs import metrics

        path = self._manifest_path()
        if not os.path.exists(path):
            return [], True
        try:
            with open(path) as f:
                doc = json.load(f)
            body = doc["body"]
            want = int(doc["crc32"])
            got = zlib.crc32(
                json.dumps(body, sort_keys=True).encode()
            )
            if got != want:
                raise ValueError(f"manifest CRC mismatch {got} != {want}")
            entries = list(body["generations"])
            for e in entries:
                int(e["gen"]), str(e["file"])  # shape check
            return entries, True
        except (OSError, ValueError, KeyError, TypeError):
            metrics.inc("lineage.manifest_torn")
            # the manifest is metadata, not data: scan the directory
            return [], False

    def _write_manifest(self, entries) -> None:
        body = {"version": 1, "keep": self.keep,
                "generations": list(entries)}
        doc = {"crc32": zlib.crc32(
            json.dumps(body, sort_keys=True).encode()
        ), "body": body}
        path = self._manifest_path()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._fsync_dir()

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.directory, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(dfd)
        except OSError:
            pass
        finally:
            os.close(dfd)

    def _scan_dir(self):
        """Generation entries recovered from the files themselves
        (filename ordering), for when the manifest is torn or absent."""
        entries = []
        for p in sorted(glob.glob(os.path.join(self.directory, "gen-*.dc"))):
            m = _GEN_RE.match(os.path.basename(p))
            if m:
                entries.append({"gen": int(m.group(1)),
                                "file": os.path.basename(p)})
        entries.sort(key=lambda e: e["gen"])
        return entries

    def generations(self):
        """The known generations, oldest first: the union of manifest
        entries and the directory scan (manifest metadata wins where
        both know a generation).  The union matters after a crash: a
        torn manifest, or a kill between manifest rewrite and rotation
        delete, leaves perfectly good generation files the manifest does
        not list — they are re-adopted here instead of orphaned.  An
        orphan must pass the envelope check first
        (``io.checkpoint.quick_validate``) so a torn stray can neither
        occupy a keep slot nor shadow a valid generation."""
        from ..obs import metrics

        entries, _healthy = self._read_manifest()
        known = {int(e["gen"]) for e in entries}
        by_gen = {}
        for e in self._scan_dir():
            gen = int(e["gen"])
            if gen in known:
                continue
            try:
                quick_validate(os.path.join(self.directory, str(e["file"])))
            except CheckpointError as err:
                metrics.inc("lineage.generations_skipped",
                            reason=f"orphan_{err.section}")
                continue
            by_gen[gen] = e
        for e in entries:
            by_gen[int(e["gen"])] = e
        return [by_gen[k] for k in sorted(by_gen)]

    # -------------------------------------------------------------- commit

    def commit(self, grid, state, spec, user_header: bytes = b"",
               ragged=None) -> int:
        """Write one new generation and rotate: returns the generation
        number.  Atomic and fsync'd end to end — a SIGKILL at ANY point
        leaves a lineage ``latest_valid`` can still resume from (the
        ``sigkill.post_commit`` injection site, fired right after the
        manifest lands, is the harness's way of proving it)."""
        from ..obs import metrics

        with metrics.phase("lineage.commit"):
            entries = self.generations()
            gen = max((int(e["gen"]) for e in entries), default=0) + 1
            fname = f"gen-{gen:06d}.dc"
            path = os.path.join(self.directory, fname)
            save_grid_data(grid, state, path, spec,
                           user_header=user_header, ragged=ragged)
            # a generation may only occupy a keep slot if its envelope
            # is structurally sound — otherwise a torn write would
            # rotate out the very generation recovery needs.  The bad
            # file is left on disk as evidence (and never enters the
            # manifest), the commit fails loudly, and the previous
            # lineage is untouched.
            try:
                quick_validate(path)
            except CheckpointError as err:
                metrics.inc("lineage.commit_rejected", reason=err.section)
                raise CheckpointError(
                    "lineage",
                    f"freshly committed generation {gen} failed "
                    f"validation ({err.section}); previous generations "
                    "are intact",
                    path,
                ) from err
            # whole-file CRC from a read-back of what actually landed on
            # disk: catches later out-of-band corruption cheaply during
            # the scan, while corruption injected during the write is
            # left to the format's own section CRCs (by design — that
            # is the detection path under test)
            entry = {"gen": gen, "file": fname,
                     "bytes": os.path.getsize(path),
                     "crc32": _file_crc(path)}
            entries = [e for e in entries if int(e["gen"]) != gen]
            entries.append(entry)
            entries.sort(key=lambda e: int(e["gen"]))
            keep = entries[-self.keep:]
            self._write_manifest(keep)
            # rotation sweep: every generation file at or below the kept
            # window that is not itself kept goes — this covers the
            # ordinary dropped-oldest case AND stray torn files from
            # earlier rejected commits or crashes
            kept_files = {str(e["file"]) for e in keep}
            max_kept = max(int(e["gen"]) for e in keep)
            for e in self._scan_dir():
                if str(e["file"]) not in kept_files \
                        and int(e["gen"]) <= max_kept:
                    try:
                        os.remove(
                            os.path.join(self.directory, str(e["file"]))
                        )
                    except OSError:
                        pass
            metrics.inc("lineage.commits")
            metrics.gauge("lineage.latest_generation", gen)
        # crash hook AFTER the commit completes: the next launch must
        # find this generation valid
        inject.maybe_kill("sigkill.post_commit")
        return gen

    # --------------------------------------------------------------- scan

    def latest_valid(self, spec, n_devices=None, device=None, ragged=None,
                     load_balancing_method: str = "RCB",
                     verify: bool = True):
        """Load the newest generation that passes every integrity check,
        scanning back past torn/corrupt/missing ones, onto ``n_devices``
        slots of ``device`` (default CUDA).  Returns ``(grid, state,
        user_header, gen)``; raises :class:`CheckpointError` (section
        ``"lineage"``) when no generation survives.

        With ``verify`` (default), the restored grid is re-verified with
        ``utils.verify.verify_grid`` before being returned — a recovered
        checkpoint that fails the invariant oracle is treated exactly
        like a corrupt one and skipped."""
        from ..obs import metrics
        from ..utils.verify import verify_grid

        with metrics.phase("lineage.scan"):
            entries = self.generations()
            tried = 0
            for e in reversed(entries):
                gen = int(e["gen"])
                path = os.path.join(self.directory, str(e["file"]))
                tried += 1
                if not os.path.exists(path):
                    metrics.inc("lineage.generations_skipped",
                                reason="missing")
                    continue
                if "bytes" in e and os.path.getsize(path) != int(e["bytes"]):
                    metrics.inc("lineage.generations_skipped",
                                reason="size")
                    continue
                if "crc32" in e and _file_crc(path) != int(e["crc32"]):
                    metrics.inc("lineage.generations_skipped",
                                reason="file_crc")
                    continue
                try:
                    grid, state, hdr = load_grid_data(
                        path, spec, n_devices=n_devices, device=device,
                        ragged=ragged,
                        load_balancing_method=load_balancing_method,
                    )
                except CheckpointError as err:
                    metrics.inc("lineage.generations_skipped",
                                reason=err.section)
                    continue
                if verify:
                    try:
                        verify_grid(grid)
                    except AssertionError:
                        metrics.inc("lineage.generations_skipped",
                                    reason="verify")
                        continue
                metrics.gauge("lineage.resumed_generation", gen)
                return grid, state, hdr, gen
        raise CheckpointError(
            "lineage",
            f"no valid generation among {tried} candidate(s)",
            self.directory,
        )

    def salvage_latest(self, spec, n_devices=None, device=None, ragged=None,
                       load_balancing_method: str = "RCB"):
        """Last-resort recovery: salvage-load the newest generation
        whose *structure* (header + cell table) is intact, accepting
        per-cell payload loss.  Returns ``(grid, state, user_header,
        gen, lost_cells)``."""
        from ..obs import metrics

        entries = self.generations()
        for e in reversed(entries):
            path = os.path.join(self.directory, str(e["file"]))
            if not os.path.exists(path):
                continue
            try:
                grid, state, hdr, lost = load_grid_data(
                    path, spec, n_devices=n_devices, device=device,
                    ragged=ragged,
                    load_balancing_method=load_balancing_method,
                    on_error="salvage",
                )
            except CheckpointError as err:
                metrics.inc("lineage.generations_skipped",
                            reason=f"salvage_{err.section}")
                continue
            return grid, state, hdr, int(e["gen"]), lost
        raise CheckpointError(
            "lineage", "no structurally intact generation to salvage",
            self.directory,
        )
