"""Worker daemon: poll the scheduler, claim jobs, run press/scan workloads.

The runtime half of the reference's dcp-server (src/server/server.c:61-100
poll loop, src/server/job.c dispatch, src/server/hmm.c press workload,
src/server/scan.c scan workload), with the scan compute re-based on the
batched device engine instead of per-thread file partitions.
"""

from __future__ import annotations

import os
import signal
import tempfile
import threading
import time

from deciphon_tpu.db.format import TensorDB, write_db
from deciphon_tpu.models.h3reader import count_profiles, press_file
from deciphon_tpu.models.profile import ProteinCfg
from deciphon_tpu.ops.scan_engine import ScanEngine, ScanParams, SeqRecord
from deciphon_tpu.server.api import SchedAPI
from deciphon_tpu.server.prod import ProdWriter
from deciphon_tpu.server.sched import JobState, JobType, SchedJob
from deciphon_tpu.utils import logging as log
from deciphon_tpu.utils import xfile
from deciphon_tpu.utils.config import ServerConfig
from deciphon_tpu.utils.progress import Progress
from deciphon_tpu.utils.rc import DcpError, EndOfData


class Server:
    def __init__(self, cfg: ServerConfig, api: SchedAPI | None = None):
        self.cfg = cfg
        self.api = api or SchedAPI(cfg.api_url, cfg.api_key)
        self._interrupt = False
        os.makedirs(cfg.cache_dir, exist_ok=True)
        from deciphon_tpu.utils import jaxcache

        jaxcache.enable()  # survive restarts without recompiling kernels

    # -- lifecycle ---------------------------------------------------------

    def install_signal_handler(self) -> None:
        """SIGINT drains gracefully (reference: server.c:24-33)."""

        def handler(signum, frame):
            log.info("Terminating it...")
            self._interrupt = True

        signal.signal(signal.SIGINT, handler)

    def run(self) -> None:
        """Poll loop (reference: server_run, server.c:61-100)."""
        log.info("Starting the server (%d workers)", self.cfg.num_workers)
        if self.cfg.single_run:
            self._interrupt = True
        while True:
            had_error = False
            try:
                ran = self.run_one()
                if not ran and not self._interrupt:
                    time.sleep(1.0 / self.cfg.polling_rate_hz)
            except DcpError as exc:
                log.error("job loop error: %s", exc)
                had_error = True
            if had_error and not self._interrupt:
                log.info("Backing off for %gs due to error",
                         self.cfg.error_backoff_s)
                time.sleep(self.cfg.error_backoff_s)
            if self._interrupt:
                break
        log.info("Goodbye!")

    def run_one(self) -> bool:
        """Claim and run at most one job; returns True if one ran."""
        try:
            job = self.api.next_pend_job()
        except EndOfData:
            return False
        self.api.set_job_state(job.id, JobState.RUN)
        log.info("Running job[%d]", job.id)
        try:
            if job.type == JobType.HMM:
                self._press(job)
            elif job.type == JobType.SCAN:
                self._scan(job)
            else:
                raise DcpError(3, f"unknown job type {job.type}")
        except Exception as exc:  # noqa: BLE001 — job granular failure
            msg = str(exc) or type(exc).__name__
            log.error("Failed job[%d]: %s", job.id, msg)
            self.api.set_job_state(job.id, JobState.FAIL, msg[:255])
            return True
        log.info("Finished job[%d]", job.id)
        return True

    # -- workloads ---------------------------------------------------------

    def _cache_path(self, filename: str) -> str:
        return os.path.join(self.cfg.cache_dir, os.path.basename(filename))

    def _press(self, job: SchedJob) -> None:
        """Press workload (reference: hmm_press, src/server/hmm.c:120-178)."""
        hmm = self.api.get_hmm_by_job_id(job.id)
        path = self._cache_path(hmm.filename)
        xfile.ensure_local(
            path, hmm.xxh3,
            lambda p, h: self.api.download_hmm(hmm.id, p),
        )
        nprofs = count_profiles(path)
        if nprofs <= 0:
            raise DcpError(2, "failed to count profiles")

        db_path = os.path.splitext(path)[0] + ".dtp"
        progress = Progress(
            nprofs,
            callback=lambda inc: self.api.increment_job_progress(job.id, inc),
        )

        def profiles():
            for p in press_file(path, ProteinCfg()):
                yield p
                progress.consume(1)

        write_db(db_path, profiles())
        progress.finish()
        log.info("Uploading pressed file")
        self.api.upload_db(db_path)
        self.api.set_job_state(job.id, JobState.DONE)
        self._press_prewarm(db_path)

    def _press_prewarm(self, db_path: str) -> None:
        """Compile the freshly-pressed DB's scan variants NOW, while no
        scan is waiting — press knows the block shapes, and the
        persistent XLA cache (utils/jaxcache.py) hands the executables to
        every later scan on this machine, so the first scan job starts
        compile-free.  Default batch shape: DCP_SCAN_BATCH reads at the
        256-nt length tier plus the 512 tier that metagenomic reads land
        in.  Runs on a BACKGROUND thread so the
        job loop keeps polling during potentially-minutes of cold
        compiles (a scan job racing the prewarm is safe: XLA compiles
        are thread-safe and the persistent cache dedupes the work); the
        throwaway engine is dropped when done so its device tables don't
        pin HBM.  DCP_PRESS_PREWARM=0 disables."""
        if os.environ.get("DCP_PRESS_PREWARM", "1") == "0":
            return

        def _warm():
            try:
                # a throwaway engine: what later scans reuse is the
                # PERSISTENT executable cache, not this instance
                engine = ScanEngine(
                    TensorDB.load(db_path), mesh=self._scan_mesh()
                )
                batch = int(os.environ.get("DCP_SCAN_BATCH", 1024))
                for max_len in (256, 512):
                    spent = engine.warmup(batch, max_len)
                    log.info(
                        "press prewarm: %d-read/%d-nt variants in %.1fs",
                        batch, max_len, spent,
                    )
                del engine  # free the device-resident block tensors
            except Exception:  # noqa: BLE001 — prewarm is best-effort
                log.warning("press prewarm failed", exc_info=True)

        t = threading.Thread(
            target=_warm, name="press-prewarm", daemon=True
        )
        t.start()
        self._prewarm_thread = t  # joinable by tests / drain

    def _scan_mesh(self):
        """('seqs' x 'profiles') mesh over all visible devices, or None
        single-chip.  The multi-device scan shards profile groups over
        'profiles' and read batches over 'seqs' (the tensor analogue of
        the reference's <=64 DB partitions, src/db/profile_reader.c:44-72);
        DCP_MESH_PROFILES overrides the profile-axis size."""
        if not hasattr(self, "_mesh"):
            import jax

            n = len(jax.devices())
            if n <= 1:
                self._mesh = None
            else:
                from deciphon_tpu.parallel.mesh import make_scan_mesh

                paxis = os.environ.get("DCP_MESH_PROFILES")
                self._mesh = make_scan_mesh(
                    profile_axis=int(paxis) if paxis else None
                )
                log.info(
                    "scan mesh: %d seqs x %d profiles",
                    self._mesh.shape["seqs"], self._mesh.shape["profiles"],
                )
        return self._mesh

    def _engine(self, path: str, xxh3: int, params: ScanParams) -> ScanEngine:
        """LRU of scan engines: repeated scans of the same DB reuse the
        tensorized profile blocks already resident on device (the fix
        for the reference's re-read-per-sequence design going one level
        further: re-use across *jobs*)."""
        key = (path, xxh3, params)
        cache = getattr(self, "_engines", None)
        if cache is None:
            cache = self._engines = {}
        if key not in cache:
            if len(cache) >= 4:  # bound device/host memory
                cache.pop(next(iter(cache)))
            cache[key] = ScanEngine(
                TensorDB.load(path), params, mesh=self._scan_mesh()
            )
        else:  # refresh LRU order
            cache[key] = cache.pop(key)
        return cache[key]

    def _scan(self, job: SchedJob) -> None:
        """Scan workload (reference: scan_run, src/server/scan.c:215-269)."""
        scan = self.api.get_scan_by_job_id(job.id)
        db_meta = self.api.get_db(scan.db_id)
        path = self._cache_path(db_meta.filename)
        xfile.ensure_local(
            path, db_meta.xxh3,
            lambda p, h: self.api.download_db(db_meta.id, p),
        )
        params = ScanParams(
            multi_hits=bool(scan.multi_hits),
            hmmer3_compat=bool(scan.hmmer3_compat),
            lrt_threshold=self.cfg.scan_lrt_threshold,
        )
        engine = self._engine(path, db_meta.xxh3, params)
        db = engine.db
        # Single scheduler pass: the reads stream once into a local spool
        # file (counting as they go), then scan in bounded batches from
        # the spool — the reference instead walks the cursor TWICE, once
        # to count (scan.c:170 -> api.c:470-485) and once per sequence
        # (scan.c:227), doubling scheduler traffic.  The spool keeps the
        # multi-GB-read-set memory envelope on disk, not in RAM.
        batch_size = int(os.environ.get("DCP_SCAN_BATCH", 1024))
        best_hit = os.environ.get("DCP_BEST_HIT", "") not in ("", "0")
        nseqs = 0
        max_len = 1
        import json as _json
        import threading

        prewarm: threading.Thread | None = None
        with tempfile.NamedTemporaryFile(
            "w+", suffix=".seqs", delete=True
        ) as spool:
            for s in self.api.iter_scan_seqs(scan.id):
                spool.write(
                    _json.dumps(
                        {"id": s.id, "name": s.name, "data": s.data}
                    )
                    + "\n"
                )
                nseqs += 1
                max_len = max(max_len, len(s.data))
                if prewarm is None:
                    # overlap kernel compiles with the (HTTP-bound) spool
                    # phase: warm with the first read's length bucket and
                    # a full batch stack now; the post-spool warmup tops
                    # up any tier this estimate missed (cached variants
                    # return instantly; engine.warmup serializes itself)
                    est_len = max_len
                    prewarm = threading.Thread(
                        target=lambda: engine.warmup(batch_size, est_len),
                        daemon=True,
                    )
                    prewarm.start()
            total = nseqs * db.nprofiles
            log.info("%d tasks to run", total)
            progress = Progress(
                total,
                callback=lambda inc: self.api.increment_job_progress(
                    job.id, inc
                ),
            )
            engine.progress = progress
            if prewarm is not None:
                prewarm.join()
            engine.warmup(min(nseqs, batch_size), max_len)
            writer = ProdWriter(scan_id=scan.id)
            batch: list[SeqRecord] = []

            def flush(batch):
                if best_hit:
                    # one row per read, device-side argmax reduction
                    # (DCP_BEST_HIT=1; no traceback/match column)
                    for b in engine.best_hits(batch):
                        if b.lrt >= self.cfg.scan_lrt_threshold:
                            writer.add(
                                b.seq_id, b.accession, b.alt_loglik,
                                b.null_loglik, "",
                            )
                    return
                for h in engine.scan(batch):
                    writer.add(
                        h.seq_id, h.accession, h.alt_loglik, h.null_loglik,
                        h.match,
                    )

            spool.seek(0)
            for line in spool:
                s = _json.loads(line)
                batch.append(SeqRecord(s["id"], s["name"], s["data"]))
                if len(batch) >= batch_size:
                    flush(batch)
                    batch = []
            if batch:
                flush(batch)
        progress.finish()
        with tempfile.NamedTemporaryFile(
            "w", suffix=".tsv", delete=False
        ) as fp:
            fp.write(writer.render())
            prods_path = fp.name
        try:
            self.api.upload_prods_file(prods_path)
        finally:
            os.unlink(prods_path)
        self.api.set_job_state(job.id, JobState.DONE)
