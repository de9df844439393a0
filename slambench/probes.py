"""What the benchmark attaches to the program: wrappers around the calls
into its layers.

``Recorder`` keeps, for the judged stages, references to each call's inputs
and outputs while ``on`` (no copy, no launch, no host read: the program's
stages are functional and never write their inputs or outputs in place).
With ``spans=True`` (``--trace 1`` only) each wrapped call also runs inside
a ``torch.profiler.record_function`` range of the layer's name and, in the
timed window, is timed on the host clock with the card synchronized at its
end (``sync``); while the profiler traces (``span_on`` false) nothing is
timed and nothing synchronized, so the traced frames run the program's own
synchronization alone.

The wrapped names are looked up where the program calls them: module
attributes (``tracker.optimize_pose``, ``tracker.match_stereo`` /
``depth_from_depthmap``, ``local_mapping.solve_ba`` / ``windowed_best2``,
``system.mapping_step``, ``pnp.ransac_pnp``) and the session's own bound
methods and hooks. ``Tracker._features`` (the extraction, and in a depth
mode the depth lookup or the right view's extraction and the stereo match)
is a span of its own, so that the right view's extraction has a time: the
features span less the extract and match spans.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import nullcontext

import torch

# span names -> the layer each times (the per-layer metrics' readers use them)
SPAN_TRACK = "system.track"
SPAN_PRE = "system.pre_frame"
SPAN_EXTRACT = "frontend.extract"
SPAN_FEATURES = "frontend.features"
SPAN_STEREO = "frontend.match_stereo"
SPAN_DEPTH = "frontend.depth_lookup"
SPAN_STEP = "tracker.track"
SPAN_RELOC = "tracker.relocalize"
SPAN_LM = "pose_opt.optimize_pose"
SPAN_PNP = "pnp.ransac_pnp"
SPAN_PASS = "mapping.mapping_step"
SPAN_BA = "mapping.solve_ba"
SPAN_FUSE = "mapping.windowed_best2"


class Recorder:
    def __init__(self, system, spans: bool, sync=torch.cuda.synchronize):
        from weiner_slamit_v2_torch.optim import pnp
        from weiner_slamit_v2_torch.tracking import local_mapping, system as system_mod, tracker

        self.sys = system
        self.t = system.tracker
        self.spans = spans
        self.sync = sync
        self.on = False
        self.span_on = True       # off while the profiler traces (it slows the host)
        self.in_reloc = False
        self.span_s: dict = defaultdict(list)
        self.extracts: list = []     # (frame, FrameFeatures)
        self.stereos: list = []      # (frame, match_stereo's args, (depth, u_right))
        self.depths: list = []       # (frame, depth_from_depthmap's args, depth)
        self.lms: list = []          # (frame, reloc?, args, kwargs, outputs)
        self.bas: list = []          # (frame, BAProblem, BAResult)
        self.fuses: list = []        # (frame, args, chi2_th, outputs)
        self.pnps: list = []         # (frame, kf, args, outputs)
        self.pnp_draw_calls: list = []   # (frame, kf, n_valid) in call order
        self._restore = []
        self._patch(tracker, "optimize_pose", self._lm, SPAN_LM)
        self._patch(tracker, "match_stereo", self._stereo, SPAN_STEREO)
        self._patch(tracker, "depth_from_depthmap", self._depth, SPAN_DEPTH)
        self._patch(local_mapping, "solve_ba", self._ba, SPAN_BA)
        self._patch(local_mapping, "windowed_best2", self._fuse, SPAN_FUSE)
        self._patch(pnp, "ransac_pnp", self._pnp, SPAN_PNP)
        self._patch(system_mod, "mapping_step", None, SPAN_PASS)
        self._patch(self.t, "_extract", self._extract, SPAN_EXTRACT)
        self._patch(self.t, "_features", None, SPAN_FEATURES)
        self._patch(self.t, "_track", None, SPAN_STEP)
        self._patch(self.t, "_relocalize", None, SPAN_RELOC, tags_reloc=True)
        self._patch(system, "_pre_frame", None, SPAN_PRE)
        draws = self.t.pnp_draws

        def pnp_draws(frame_id, kf_id, n_valid):
            if self.on:
                self.pnp_draw_calls.append((frame_id, kf_id, n_valid))
            return draws(frame_id, kf_id, n_valid)
        self.t.pnp_draws = pnp_draws
        self._restore.append(lambda: setattr(self.t, "pnp_draws", draws))

    # -- wrapping ------------------------------------------------------------

    def _patch(self, owner, name: str, record, span: str, tags_reloc: bool = False) -> None:
        """Replace ``owner.name`` by a wrapper; ``record(args, kwargs, out)``
        keeps a judged stage's call; ``tags_reloc`` marks the pose LMs made
        inside the call as the relocalization's."""
        orig = getattr(owner, name)
        had_own = name in getattr(owner, "__dict__", {})

        def wrapped(*args, **kwargs):
            ctx = torch.profiler.record_function(span) if self.spans else nullcontext()
            with ctx:
                t0 = time.perf_counter()
                self.in_reloc |= tags_reloc
                try:
                    out = orig(*args, **kwargs)
                finally:
                    if tags_reloc:
                        self.in_reloc = False
                if self.spans and self.on and self.span_on:
                    self.sync()
                    self.span_s[span].append(time.perf_counter() - t0)
            if record is not None and self.on:
                record(args, kwargs, out)
            return out

        setattr(owner, name, wrapped)
        if had_own:
            self._restore.append(lambda: setattr(owner, name, orig))
        else:
            self._restore.append(lambda: delattr(owner, name))

    def close(self) -> None:
        for undo in reversed(self._restore):
            undo()
        self._restore.clear()

    def span(self, name: str):
        """A span of the benchmark's own around a whole call."""
        return torch.profiler.record_function(name) if self.spans else nullcontext()

    # -- the judged stages ---------------------------------------------------------

    def _extract(self, args, kwargs, out):
        self.extracts.append((self.t.frame_id, out))

    def _stereo(self, args, kwargs, out):
        self.stereos.append((self.t.frame_id, args, out))

    def _depth(self, args, kwargs, out):
        self.depths.append((self.t.frame_id, args, out))

    def _lm(self, args, kwargs, out):
        self.lms.append((self.t.frame_id, self.in_reloc, args, kwargs, out))

    def _ba(self, args, kwargs, out):
        self.bas.append((self.t.frame_id, args[0], out))

    def _fuse(self, args, kwargs, out):
        self.fuses.append((self.t.frame_id, args[:11], args[11], out))

    def _pnp(self, args, kwargs, out):
        self.pnps.append((self.t.frame_id, args, out))
