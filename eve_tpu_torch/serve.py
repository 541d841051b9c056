"""Serving engine: micro-batched, stateful EVE inference on one device.

The counterpart of ``eve_tpu/serve.py`` (the spec+params path, host-stacked
or device-resident), with the same contract:

- A background batcher thread gathers requests from a bounded queue for up
  to ``max_delay_ms`` (or until ``max_batch`` are pending) and runs them as
  one forward, padded to ``max_batch`` so every dispatch has one shape.
- Sessions carry the recurrent state (EyeNet cells, RefineNet bottleneck)
  across consecutive chunks of one video, so results match the whole video
  as one clip. Chunks of one session run strictly in submission order; a
  failed or expired chunk marks the session broken, and every successor
  fails until the client closes the session and restarts the stream.
  Requests without a session get fresh state.
- Queue bound, request timeouts, session TTL, drain/stop and stats.
- By default the host keeps each session's states as float32 numpy arrays
  (numpy has no bfloat16); a dispatch stacks the inputs and states on the
  host, copies them to the device and casts the states to the model's
  state types (bfloat16 RefineNet states under the bfloat16 compute type),
  and copies every output and state back. bfloat16 -> float32 -> bfloat16
  is exact, so a chunked session still equals one forward over the whole
  clip.
- ``device_resident=True`` keeps each session's states on the device in
  the model's own types and assembles the batch there: inputs that are
  already tensors pass through ``submit`` untouched (numpy inputs are
  copied to the device slot by slot), the slots are stacked with
  ``torch.stack`` and the states joined with ``torch.cat``, each slot's new
  state is sliced and cloned (so one session's state never pins the whole
  batch), and only the served outputs are copied back. Both modes run the
  same batch through the same forward, so their results are equal.

- ``artifact=`` serves an AOT artifact (``eve_tpu_torch.export``) in
  place of spec and params: no model code is imported, ``max_batch`` is the
  artifact's batch size, and a request of any other signature fails. A
  streaming artifact serves sessions and session-less requests (zero
  states from the artifact's own state types); a non-streaming one refuses
  sessions.

- ``mesh=`` (a ``parallel.mesh.DataMesh``, or a device count) serves
  data-parallel across devices in this process, eve_tpu's ``mesh=``: the
  parameters are replicated to each device, and each padded dispatch
  splits its ``max_batch`` slots into equal contiguous slices, one a
  device (``max_batch`` must divide by the mesh), whose forwards are all
  launched before any output is read. With ``device_resident`` a session's
  state stays on the device of the slot its last chunk ran in; when its
  next chunk lands in a slot of another device the state is copied there
  (eve_tpu replicates it instead). The slots compute the same function
  whatever device they lie on, so a session's results do not depend on
  its slot. Not with ``artifact=`` (eve_tpu's ``ValueError``).

- While a torch profiler records, the batcher records spans
  (``eve_tpu_torch.tracing``): ``serve.idle`` (waiting for a first
  request), ``serve.gather`` (until the batch closes) and
  ``serve.dispatch``, whose children are a ``serve.queue_wait`` a request
  (submit to dispatch), ``serve.stack`` (host stacking), ``serve.h2d``
  (a slice's inputs and states to the device; with ``device_resident``
  their stacking there), ``serve.forward`` (a slice's forward launch) and
  ``serve.d2h`` (the copies back, which wait for the card).

PyTorch runs eagerly, so there is no per-signature compile cache;
``max_signatures`` still bounds the distinct input shapes a client can
send.

The HTTP front end (``make_http_server``) is stdlib-only with numpy
``.npz`` bodies, the same protocol as eve_tpu's.
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
import time
import uuid
from concurrent.futures import Future, TimeoutError as FuturesTimeoutError
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from eve_tpu_torch import tracing
from eve_tpu_torch.parallel import mesh as mesh_lib
from eve_tpu_torch.utils.tensors import batch_to_tensors, tree_map

logger = logging.getLogger(__name__)

# Outputs served by default: the quantities the reference's evaluation
# scores, plus gaze vectors.
DEFAULT_SERVED_OUTPUTS = (
    'PoG_px_initial', 'PoG_px_final', 'PoG_cm_final',
    'left_pupil_size', 'right_pupil_size', 'g_initial', 'g_final',
)


class UnknownSessionError(KeyError):
    """The request names a session that does not (or no longer) exist."""


class EngineOverloadedError(RuntimeError):
    """The request queue is full or the request timed out waiting in it."""


class EngineDrainingError(RuntimeError):
    """The engine is draining for shutdown and accepts no new requests."""


@dataclass
class _Request:
    inputs: Dict[str, np.ndarray]  # per-clip arrays, leading dim T
    session_id: Optional[str]
    # The Session object captured at submit time: identity against the
    # current mapping detects a chunk whose session was closed (and maybe
    # reopened) while it was queued.
    session: Optional["Session"] = None
    future: Future = field(default_factory=Future)
    signature: tuple = ()
    enqueued_at: float = 0.0


class Session:
    """Recurrent state + ordering for one video stream."""

    def __init__(self, session_id, state):
        self.session_id = session_id
        # Leading dim 1: a host float32 numpy tree, or with
        # device_resident a tree of tensors on the device, never written
        # in place.
        self.state = state
        self.chunks_processed = 0
        self.last_used = time.monotonic()


class ServingEngine:
    """Micro-batching inference engine over one EVE model."""

    def __init__(self, spec=None, params=None, *, device='cuda',
                 artifact=None,
                 max_batch=8, max_delay_ms=5.0,
                 served_outputs=DEFAULT_SERVED_OUTPUTS,
                 max_sessions=1024, max_signatures=8,
                 max_queue=64, request_timeout_s=30.0,
                 session_ttl_s=600.0, mesh=None, device_resident=False):
        """``params`` is a state dict of the port's ``EVE`` model (see
        ``eve_tpu_torch.utils.convert.eve_state_dict`` for eve_tpu trees).

        ``served_outputs`` bounds what a dispatch copies back to the host
        (None = every output). ``max_sessions`` and ``max_signatures`` bound
        the open sessions and the distinct input (shape, dtype) signatures.
        ``max_queue`` bounds pending requests (overflow raises
        EngineOverloadedError); ``request_timeout_s`` fails requests that
        waited longer in the queue. ``session_ttl_s``: sessions idle longer
        are evicted on the next ``open_session`` (0 disables), floored at
        2x ``request_timeout_s`` so a session with a queued chunk never
        ages out. ``device_resident``: session states and batch assembly on
        the device (see the module docstring).

        ``artifact``: an ``ExportedModel``, or the bytes or path of an
        artifact exported for ``device``'s type, served in place of
        ``spec`` and ``params``; it fixes ``max_batch`` and the one input
        signature.

        ``mesh``: a ``DataMesh`` or a device count (``make_mesh(n)`` on
        the cards, n replicas of ``device`` elsewhere) to serve
        data-parallel over; ``device`` is then the mesh's first device.
        """
        if device_resident and artifact is not None:
            raise ValueError(
                'device_resident serving needs the spec+params path '
                '(AOT artifacts fix their own input layout)')
        mesh = mesh_lib.as_mesh(mesh, device)
        if mesh is not None:
            if artifact is not None:
                raise ValueError(
                    'mesh serving needs spec+params; AOT artifacts are '
                    'compiled for a single device')
            if int(max_batch) % mesh.size:
                raise ValueError(
                    'max_batch=%d must divide by the %d-device %r mesh axis '
                    '(every dispatch pads to max_batch, so each device '
                    'takes an equal slot count)'
                    % (int(max_batch), mesh.size, mesh.axis_names[0]))
            device = mesh.devices[0]
        self.mesh = mesh
        if artifact is None:
            if spec is None or params is None:
                raise ValueError(
                    'pass spec AND params (got spec=%s, params=%s), or '
                    'artifact=...' % (type(spec).__name__,
                                      type(params).__name__))
        elif spec is not None or params is not None:
            raise ValueError('pass either spec+params or artifact, not both')
        # cuDNN runs float32 convolutions in TF32 by default, which keeps
        # about three decimal digits; the port serves float32 and is held to
        # eve_tpu's float32 results, so TF32 is off for convolutions and
        # matrix products alike.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.spec = spec
        self.device = torch.device(device)
        self.device_resident = bool(device_resident)
        self._model = self._artifact = None
        if artifact is None:
            from eve_tpu_torch.models import eve as eve_lib
            self._model = eve_lib.build_model(
                spec, {k: torch.as_tensor(v) for k, v in params.items()},
                self.device)
            zero = eve_lib.init_stream_state(spec, 1, self.device)
            # The devices of the slot slices and their models: one slice
            # of every slot without a mesh.
            self._slice_devices = (mesh.devices if mesh is not None
                                   else (self.device,))
            self._replicas = (mesh_lib.replicate(mesh, self._model)
                              if mesh is not None else [self._model])
        else:
            from eve_tpu_torch.export import ExportedModel, load_exported
            self._artifact = (artifact if isinstance(artifact, ExportedModel)
                              else load_exported(artifact, self.device))
            if self._artifact.device.type != self.device.type:
                raise ValueError('an artifact for %s cannot serve on %s'
                                 % (self._artifact.device, self.device))
            if int(max_batch) != self._artifact.batch_size:
                logger.warning('max_batch=%d overridden to the artifact\'s '
                               'exported batch size %d', max_batch,
                               self._artifact.batch_size)
            max_batch = self._artifact.batch_size
            self._artifact_signature = tuple(sorted(
                (k, shape[1:], dtype)
                for k, shape, dtype in self._artifact.input_signature))
            zero = self._artifact.zero_state(1)
            self._slice_devices = (self.device,)
            self._replicas = [self._artifact]
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.served_outputs = (tuple(served_outputs)
                               if served_outputs is not None else None)
        self.max_sessions = int(max_sessions)
        self.max_signatures = int(max_signatures)
        self.request_timeout_s = float(request_timeout_s)
        self.session_ttl_s = float(session_ttl_s)
        if self.session_ttl_s:
            self.session_ttl_s = max(self.session_ttl_s,
                                     2.0 * self.request_timeout_s)
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=int(max_queue))
        self._deferred: List[_Request] = []  # owned by the batcher thread
        self._deferred_sessions = set()
        # Session objects with a failed or expired chunk: their successors
        # fail too. Objects, not ids, so a closed-and-reopened id starts
        # clean. Mutated by the batcher and (on client timeouts) by caller
        # threads; single set operations are atomic under the GIL.
        self._broken_sessions = set()
        self._sessions: Dict[str, Session] = {}
        self._sessions_lock = threading.Lock()
        if self.device_resident:
            # Made once, on the device; every session starts from it (a
            # copy of it on each other device of the mesh).
            self._zero_state = zero
            self._zero_states = {
                d: tree_map(lambda t, d=d: t.to(d), zero)
                for d in self._slice_devices}
        else:
            self._state_dtypes = tree_map(lambda t: t.dtype, zero)
            self._zero_state = tree_map(lambda t: t.float().cpu().numpy(),
                                        zero)
        self._signatures = set()  # owned by the batcher thread
        self._stats_lock = threading.Lock()
        self.stats = {
            'requests': 0, 'batches': 0, 'batched_slots': 0,
            'errors': 0, 'sessions_opened': 0, 'sessions_evicted': 0,
            'rejected': 0, 'timed_out': 0, 'rejected_draining': 0,
        }
        # Accepted-but-unresolved requests: incremented before the queue put
        # and decremented exactly once when the future resolves, so drain()
        # seeing 0 proves nothing accepted is pending.
        self._inflight = 0
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='eve-serving-batcher')
        self._thread.start()

    # ---------------- public API ----------------

    @property
    def model(self):
        """The served ``EVE`` module (eval mode, on ``self.device``); None
        when serving an artifact."""
        return self._model

    def open_session(self, session_id=None):
        """Allocate fresh recurrent state; returns the session id."""
        if self._artifact is not None and not self._artifact.streaming:
            raise RuntimeError(
                'sessions need a streaming artifact (export with '
                '--export-streaming yes); this one would reset the '
                'recurrent state every chunk')
        if self._draining.is_set():
            self._stat_inc('rejected_draining')
            raise EngineDrainingError(
                'serving engine is draining for shutdown; no new sessions')
        if self._stop.is_set():
            raise RuntimeError('serving engine stopped')
        session_id = session_id or uuid.uuid4().hex
        evicted = 0
        with self._sessions_lock:
            if session_id in self._sessions:
                raise ValueError('session exists: %s' % session_id)
            if self.session_ttl_s:
                # Reap abandoned streams before the capacity check.
                cutoff = time.monotonic() - self.session_ttl_s
                for sid in [sid for sid, s in self._sessions.items()
                            if s.last_used < cutoff]:
                    stale = self._sessions.pop(sid)
                    self._broken_sessions.discard(stale)
                    evicted += 1
            if len(self._sessions) >= self.max_sessions:
                raise RuntimeError(
                    'session limit reached (%d); close unused sessions'
                    % self.max_sessions)
            self._sessions[session_id] = Session(
                session_id, self._zero_state if self.device_resident
                else tree_map(np.copy, self._zero_state))
        if evicted:
            self._stat_inc('sessions_evicted', evicted)
            logger.info('evicted %d idle session(s) past the %.0fs TTL',
                        evicted, self.session_ttl_s)
        self._stat_inc('sessions_opened')
        return session_id

    def _stat_inc(self, key, n=1):
        with self._stats_lock:
            self.stats[key] += n

    def _resolve_request(self, r, result):
        """Complete an accepted request (exactly-once in-flight release)."""
        r.future.set_result(result)
        with self._stats_lock:
            self._inflight -= 1

    def _fail_request(self, r, exc):
        """Fail an accepted request; returns False if it already resolved."""
        if r.future.done():
            return False
        r.future.set_exception(exc)
        with self._stats_lock:
            self._inflight -= 1
        return True

    def close_session(self, session_id):
        with self._sessions_lock:
            session = self._sessions.pop(session_id, None)
        if session is not None:
            self._broken_sessions.discard(session)

    def submit(self, inputs, session_id=None) -> Future:
        """Enqueue one clip (arrays with leading dim T); returns a Future.

        The future resolves to the served output dict with per-sample arrays
        (batch dim stripped). With a ``session_id`` the recurrent state is
        carried from this session's previous chunk. A ``torch.Tensor``
        passes through untouched (with ``device_resident`` it is stacked
        where it lies); anything else becomes a numpy array.
        """
        if self._draining.is_set():
            self._stat_inc('rejected_draining')
            raise EngineDrainingError(
                'serving engine is draining for shutdown')
        if self._stop.is_set():
            raise RuntimeError('serving engine stopped')
        session = None
        if session_id is not None:
            with self._sessions_lock:
                session = self._sessions.get(session_id)
                if session is not None:
                    session.last_used = time.monotonic()
            if session is None:
                raise UnknownSessionError('unknown session: %s' % session_id)
        req = _Request(
            inputs={k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                    for k, v in inputs.items()},
            session_id=session_id, session=session,
            enqueued_at=time.perf_counter())
        # Tensors and numpy arrays of one shape and type share a signature.
        req.signature = tuple(sorted(
            (k, tuple(v.shape), str(v.dtype).replace('torch.', ''))
            for k, v in req.inputs.items()))
        with self._stats_lock:
            self._inflight += 1
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self._inflight -= 1
            self._stat_inc('rejected')
            raise EngineOverloadedError(
                'request queue full (%d pending); retry later'
                % self._queue.maxsize)
        if self._stop.is_set():
            # stop() may have drained the queue before our put landed.
            self._fail_queued(RuntimeError('serving engine stopped'))
        return req.future

    def infer(self, inputs, session_id=None, timeout=None):
        """Blocking :meth:`submit`.

        ``timeout=None`` waits ``request_timeout_s`` plus a 120 s allowance
        for the first dispatch of a new shape. A client-side timeout marks
        the session broken: the chunk may still run and advance the state.
        """
        if timeout is None:
            timeout = self.request_timeout_s + 120.0
        future = self.submit(inputs, session_id)
        try:
            return future.result(timeout=timeout)
        except FuturesTimeoutError:
            if session_id is not None:
                with self._sessions_lock:
                    session = self._sessions.get(session_id)
                if session is not None:
                    self._broken_sessions.add(session)
            raise

    def drain(self, timeout=None):
        """Graceful shutdown: reject new work, finish accepted work, stop."""
        self._draining.set()
        if timeout is None:
            timeout = self.request_timeout_s + 120.0
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._stats_lock:
                inflight = self._inflight
            if inflight == 0:
                break
            time.sleep(0.02)
        self.stop()

    def stop(self):
        """Stop the batcher and promptly fail all pending requests."""
        self._stop.set()
        self._thread.join(timeout=10.0)
        err = RuntimeError('serving engine stopped')
        for r in self._deferred:
            self._fail_request(r, err)
        self._deferred = []
        self._deferred_sessions = set()
        self._fail_queued(err)

    def _fail_queued(self, err):
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            self._fail_request(r, err)

    def get_stats(self):
        """Counters plus live queue/deferred depth (for monitoring)."""
        with self._stats_lock:
            out = dict(self.stats)
            out['inflight'] = self._inflight
        out['queue_depth'] = self._queue.qsize()
        out['deferred'] = len(self._deferred)
        out['draining'] = self._draining.is_set()
        with self._sessions_lock:
            out['sessions_open'] = len(self._sessions)
        return out

    # ---------------- batcher ----------------

    def _loop(self):
        while not self._stop.is_set():
            reqs: List[_Request] = []
            sessions_in_batch = set()
            # Seed from deferred (oldest first), else block briefly.
            pending, self._deferred = self._deferred, []
            self._deferred_sessions = set()
            for r in pending:
                self._try_add(r, reqs, sessions_in_batch)
            if not reqs:
                try:
                    with tracing.span('serve.idle'):
                        first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._try_add(first, reqs, sessions_in_batch)
                if not reqs:
                    continue
            with tracing.span('serve.gather'):
                deadline = time.perf_counter() + self.max_delay_s
                while len(reqs) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        r = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    self._try_add(r, reqs, sessions_in_batch)
            try:
                with tracing.span('serve.dispatch') as dispatch:
                    if dispatch is not None:
                        _record_queue_waits(reqs, dispatch)
                    self._dispatch(reqs)
            except Exception as e:  # noqa: BLE001 - the batcher must survive
                logger.exception('dispatch failed')
                newly_failed = [r for r in reqs if not r.future.done()]
                self._stat_inc('errors', len(newly_failed))
                for r in newly_failed:
                    self._fail_request(r, e)
                # A session whose chunk failed must not continue from
                # pre-failure state: fail its deferred successors too.
                failed = {r.session for r in newly_failed
                          if r.session is not None}
                self._broken_sessions |= failed
                if failed:
                    keep = []
                    for r in self._deferred:
                        if r.session in failed:
                            self._stat_inc('errors')
                            self._fail_request(r, RuntimeError(
                                'a previous chunk of session %s failed'
                                % r.session_id))
                        else:
                            keep.append(r)
                    self._deferred = keep
                    self._deferred_sessions = {
                        r.session_id for r in keep
                        if r.session_id is not None}

    def _try_add(self, r, reqs, sessions_in_batch):
        """Add a request to the batch, or defer or expire it.

        Defers when its session has an earlier chunk deferred, already has a
        chunk in this batch, its signature differs from the batch head's, or
        the batch is full. Requests older than ``request_timeout_s`` fail.
        """
        if r.session is not None:
            with self._sessions_lock:
                current = self._sessions.get(r.session_id) is r.session
            if not current:
                self._stat_inc('errors')
                self._fail_request(r, UnknownSessionError(
                    'session closed before dispatch: %s' % r.session_id))
                return False
            if r.session in self._broken_sessions:
                self._stat_inc('errors')
                self._fail_request(r, RuntimeError(
                    'a previous chunk of session %s failed or expired; '
                    'close the session and restart the stream'
                    % r.session_id))
                return False
        if (time.perf_counter() - r.enqueued_at) > self.request_timeout_s:
            self._stat_inc('errors')
            self._stat_inc('timed_out')
            self._fail_request(r, EngineOverloadedError(
                'request waited > %.1fs in queue' % self.request_timeout_s))
            if r.session is not None:
                self._broken_sessions.add(r.session)
            return False

        def defer():
            self._deferred.append(r)
            if r.session_id is not None:
                self._deferred_sessions.add(r.session_id)
            return False

        if r.session_id is not None and r.session_id in self._deferred_sessions:
            return defer()
        if reqs and r.signature != reqs[0].signature:
            return defer()
        if r.session_id is not None and r.session_id in sessions_in_batch:
            return defer()
        if len(reqs) >= self.max_batch:
            return defer()
        reqs.append(r)
        if r.session_id is not None:
            sessions_in_batch.add(r.session_id)
        return True

    def _check_signature(self, signature):
        if self._artifact is not None:
            if signature != self._artifact_signature:
                raise RuntimeError(
                    'input signature %s does not match the serving '
                    'artifact\'s exported signature %s (AOT artifacts serve '
                    'exactly one shape; pad clips client-side or re-export)'
                    % (signature, self._artifact_signature))
            return
        if signature not in self._signatures:
            if len(self._signatures) >= self.max_signatures:
                raise RuntimeError(
                    'input-signature limit reached (%d distinct shapes); '
                    'pad clips to a fixed shape client-side'
                    % self.max_signatures)
            self._signatures.add(signature)

    def _forward(self, model, batch, states):
        """One forward of a slice's device tensors on ``model`` (a replica
        or the artifact): ``(served outputs and new states, on the
        device)``; nothing is copied back here."""
        if self._artifact is None:
            out = model(batch, output_predictions=True,
                        initial_states=states, return_states=True)
        elif self._artifact.streaming:
            out = model(batch, states)
        else:
            out = dict(model(batch), states=states)
        states_out = out.pop('states')
        if self.served_outputs is not None:
            out = {k: out[k] for k in self.served_outputs if k in out}
        return out, states_out

    def _slices(self):
        """``(device, model, first slot, end slot)`` of each slice of the
        ``max_batch`` slots."""
        bounds = mesh_lib.row_slices(self.max_batch,
                                     len(self._slice_devices))
        return [(d, m, a, b) for d, m, (a, b) in
                zip(self._slice_devices, self._replicas, bounds)]

    def _run_slices(self, make_inputs):
        """Launch every slice's forward (``make_inputs(device, a, b)`` gives
        its batch and states), then read the served outputs back to the
        host in slot order. Returns ``(host outputs, [(slots, device
        states)])``."""
        launched = []
        with torch.inference_mode():
            for device, model, a, b in self._slices():
                with tracing.span('serve.h2d'):
                    inputs = make_inputs(device, a, b)
                with tracing.span('serve.forward'):
                    out, states = self._forward(model, *inputs)
                launched.append((range(a, b), out, states))
            with tracing.span('serve.d2h'):
                host = mesh_lib.gather_rows(
                    [{k: v.cpu().numpy() for k, v in out.items()}
                     for _, out, _ in launched],
                    self.max_batch // len(launched))
        return host, [(slots, states) for slots, _, states in launched]

    def _run_host(self, reqs, slot_states, pad):
        """The default mode: stack on the host, copy each slice in, copy
        every output and state out. Returns ``(host outputs, slot -> new
        state)``."""
        with tracing.span('serve.stack'):
            batch = {}
            for k in reqs[0].inputs:
                stacked = np.stack([_host_array(r.inputs[k]) for r in reqs])
                if pad:
                    stacked = np.concatenate(
                        [stacked, np.repeat(stacked[-1:], pad, axis=0)])
                batch[k] = stacked
            states = tree_map(lambda *xs: np.concatenate(xs, axis=0),
                              *slot_states)

        def make_inputs(device, a, b):
            return (batch_to_tensors({k: v[a:b] for k, v in batch.items()},
                                     device),
                    tree_map(lambda x, dtype: torch.from_numpy(x[a:b])
                             .to(device).to(dtype), states,
                             self._state_dtypes))

        host, parts = self._run_slices(make_inputs)
        with tracing.span('serve.d2h'):
            new_states = tree_map(
                lambda *xs: np.concatenate(xs, axis=0),
                *[tree_map(lambda t: t.float().cpu().numpy(), states)
                  for _, states in parts])
        return host, lambda i: tree_map(lambda x: np.copy(x[i:i + 1]),
                                        new_states)

    def _run_resident(self, reqs, slot_states, pad):
        """``device_resident``: stack each slice's slots and join their
        states on the slice's device (a state on another device is copied
        there); only the served outputs come back. Returns ``(host
        outputs, slot -> new state)``."""
        slot_inputs = [r.inputs for r in reqs]
        slot_inputs += [slot_inputs[-1]] * pad

        def make_inputs(device, a, b):
            # Each distinct request once: the padding slots repeat the
            # last one's tensors.
            copied, slots = {}, []
            for inputs in slot_inputs[a:b]:
                if id(inputs) not in copied:
                    copied[id(inputs)] = batch_to_tensors(inputs, device)
                slots.append(copied[id(inputs)])
            batch = {k: torch.stack([s[k] for s in slots])
                     for k in slots[0]}
            states = tree_map(lambda *xs: torch.cat(
                [x.to(device) for x in xs], dim=0), *slot_states[a:b])
            return batch, states

        host, parts = self._run_slices(make_inputs)
        owner = {i: (states, i - slots.start)
                 for slots, states in parts for i in slots}

        def slot_state(i):
            states, j = owner[i]
            return tree_map(lambda t: t[j:j + 1].clone(), states)
        return host, slot_state

    def _dispatch(self, reqs: List[_Request]):
        # A session closed between submit() and here fails its chunk instead
        # of running on freshly zeroed state mid-stream.
        live: List[_Request] = []
        sessions: List[Optional[Session]] = []
        dropped = 0
        with self._sessions_lock:
            for r in reqs:
                if r.session is None:
                    live.append(r)
                    sessions.append(None)
                elif self._sessions.get(r.session_id) is r.session:
                    live.append(r)
                    sessions.append(r.session)
                else:
                    dropped += 1
                    self._fail_request(r, UnknownSessionError(
                        'session closed before dispatch: %s' % r.session_id))
        if dropped:
            self._stat_inc('errors', dropped)
        reqs = live
        if not reqs:
            return
        self._check_signature(reqs[0].signature)
        n = len(reqs)
        pad = self.max_batch - n
        if self.device_resident:
            # A fresh or padding slot starts from the zero state on its own
            # slice's device.
            zeros = [self._zero_states[d] for d, _, a, b in self._slices()
                     for _ in range(a, b)]
        else:
            zeros = [self._zero_state] * self.max_batch
        slot_states = [s.state if s else zeros[i]
                       for i, s in enumerate(sessions)]
        slot_states += zeros[n:]
        run = self._run_resident if self.device_resident else self._run_host
        host, slot_state = run(reqs, slot_states, pad)

        with self._sessions_lock:
            for i, s in enumerate(sessions):
                # The session may have been closed mid-flight.
                if s is not None and self._sessions.get(s.session_id) is s:
                    s.state = slot_state(i)
                    s.chunks_processed += 1
                    s.last_used = time.monotonic()
        for i, r in enumerate(reqs):
            per_sample = {}
            for k, v in host.items():
                if v.ndim >= 1 and v.shape[0] == self.max_batch:
                    per_sample[k] = v[i]
                elif v.ndim == 0:
                    per_sample[k] = v
            self._resolve_request(r, per_sample)
        with self._stats_lock:
            self.stats['requests'] += n
            self.stats['batches'] += 1
            self.stats['batched_slots'] += n


def _record_queue_waits(reqs, dispatch):
    """One ``serve.queue_wait`` span a request, keyed by its session: from
    its submit stamp (``time.perf_counter``, shifted once onto the spans'
    clock) to the start of ``dispatch``, the open span it is a child of."""
    shift_ns = tracing.now_ns() - time.perf_counter_ns()
    for r in reqs:
        tracing.record('serve.queue_wait',
                       int(r.enqueued_at * 1e9) + shift_ns, dispatch.start_ns,
                       key=r.session_id)


def _host_array(v):
    """A request input as a numpy array (a tensor is copied to the host)."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


# ----------------------------------------------------------------------
# HTTP front end (stdlib only; npz bodies)
# ----------------------------------------------------------------------

def _npz_bytes(arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_parse(body):
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def make_http_server(engine: ServingEngine, host='127.0.0.1', port=0,
                     served_outputs=None,
                     max_body_bytes=256 * 1024 * 1024,
                     keepalive_timeout_s=15.0):
    """Build a ``ThreadingHTTPServer`` exposing the engine.

    Routes:
      GET  /healthz                      -> {"status": "ok"} (503 draining)
      GET  /v1/stats                     -> engine stats JSON
      POST /v1/sessions                  -> {"session_id": ...}
      DELETE /v1/sessions/<id>           -> {}
      POST /v1/infer  (npz body; optional X-Session-Id header)
           -> npz of served output arrays

    413 for bodies over ``max_body_bytes`` (refused before reading), 429 +
    Retry-After when the queue is full or the request timed out, 503 while
    draining. ``keepalive_timeout_s`` bounds how long a handler thread
    blocks on an idle keep-alive connection.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'
        timeout = float(keepalive_timeout_s)

        def log_message(self, fmt, *args):
            logger.debug('http: ' + fmt, *args)

        def _json(self, code, obj):
            self._bytes(code, json.dumps(obj).encode(), 'application/json')

        def _bytes(self, code, body, ctype='application/octet-stream',
                   headers=()):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            for name, value in headers:
                self.send_header(name, value)
            if self.close_connection:
                self.send_header('Connection', 'close')
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                if engine._draining.is_set():
                    self._json(503, {'status': 'draining'})
                else:
                    self._json(200, {'status': 'ok'})
            elif self.path == '/v1/stats':
                self._json(200, engine.get_stats())
            else:
                self._json(404, {'error': 'not found'})

        def do_POST(self):
            try:
                if self.path == '/v1/sessions':
                    self._json(200, {'session_id': engine.open_session()})
                    return
                if self.path == '/v1/infer':
                    # A refusal before the body is read closes the
                    # connection: leftover bytes would parse as the next
                    # request on a keep-alive stream.
                    if 'chunked' in (self.headers.get('Transfer-Encoding')
                                     or '').lower():
                        self.close_connection = True
                        self._json(411, {
                            'error': 'chunked bodies unsupported; send '
                                     'Content-Length'})
                        return
                    raw_length = self.headers.get('Content-Length')
                    if raw_length is None or not raw_length.strip().isdigit():
                        self.close_connection = True
                        self._json(411 if raw_length is None else 400, {
                            'error': 'missing or malformed Content-Length'})
                        return
                    length = int(raw_length)
                    if length > max_body_bytes:
                        self.close_connection = True
                        self._json(413, {
                            'error': 'body of %d bytes exceeds limit %d'
                                     % (length, max_body_bytes)})
                        return
                    inputs = _npz_parse(self.rfile.read(length))
                    sid = self.headers.get('X-Session-Id') or None
                    out = engine.infer(inputs, session_id=sid)
                    keys = (served_outputs if served_outputs is not None
                            else engine.served_outputs)
                    served = out if keys is None else {
                        k: out[k] for k in keys if k in out}
                    self._bytes(200, _npz_bytes(served))
                    return
                self._json(404, {'error': 'not found'})
            except UnknownSessionError as e:
                self._json(404, {'error': str(e)})
            except EngineDrainingError as e:
                self.close_connection = True
                self._json(503, {'error': str(e)})
            except EngineOverloadedError as e:
                self._bytes(429, json.dumps({'error': str(e)}).encode(),
                            'application/json', (('Retry-After', '1'),))
            except Exception as e:  # noqa: BLE001 - answer, never hang up
                logger.exception('request failed')
                # The body may not have been fully read: never reuse this
                # connection.
                self.close_connection = True
                self._json(500, {'error': repr(e)})

        def do_DELETE(self):
            prefix = '/v1/sessions/'
            if self.path.startswith(prefix):
                engine.close_session(self.path[len(prefix):])
                self._json(200, {})
            else:
                self._json(404, {'error': 'not found'})

    return ThreadingHTTPServer((host, port), Handler)
