#!/usr/bin/env python3
"""Serve EVE gaze inference over HTTP with the PyTorch port.

Usage:
    python -m eve_tpu_torch.cli.serve [config.json ...] [--flags] \
        --resume-from <run_dir> [--serve-port 8000] [--device cuda]
    python -m eve_tpu_torch.cli.serve --serve-artifact m.pt2 [--flags]

Every configuration key is also a ``--flag``; JSON files apply in order and
flags override them. ``--resume-from`` names an eve_tpu run directory: the
newest ``checkpoints/NNNNNNN.ckpt`` is served. Without weights the command
refuses to start (it never serves random parameters).
``--serve-artifact`` serves an AOT artifact of
``python -m eve_tpu_torch.cli.export_model`` instead, reading no
checkpoint and importing no model code; the artifact fixes the batch size
and the one input signature. ``--serve-num-devices N`` (N > 1) serves
data-parallel over N cards in this process (``ServingEngine(mesh=N)``:
the model on each, every dispatch's slots split over them;
``--serve-max-batch`` must divide by N; not with ``--serve-artifact``).

Protocol (stdlib HTTP, numpy .npz bodies), as eve_tpu's:

    POST /v1/sessions                 -> {"session_id": s}
    POST /v1/infer (X-Session-Id: s, body=npz of model inputs)
                                      -> npz of PoG/pupil/gaze outputs
    DELETE /v1/sessions/s
"""

import logging
import os
import signal
import threading

from eve_tpu_torch.cli import common

logger = logging.getLogger(__name__)


def parse_config(argv=None, description='Serve EVE inference over HTTP.'):
    """``(config, args)`` from JSON files and ``--flags``; the full
    pipeline (RefineNet with screen content) unless a flag says otherwise,
    e.g. --refine-net-enabled no for an EyeNet-only model."""
    return common.parse_config(argv, description, defaults={
        'refine_net_enabled': True, 'load_screen_content': True})


def model_setup(config):
    """``(spec, state_dict)`` from ``--resume-from``; refuses without one."""
    from eve_tpu_torch.models import zoo
    from eve_tpu_torch.models.eve import EveSpec
    from eve_tpu_torch.utils import checkpoint, convert

    zoo.refuse('serving', config)
    spec = EveSpec.from_config(config)
    if not config.resume_from:
        raise RuntimeError(
            'No weights: pass --resume-from <run_dir> (refusing to serve '
            'randomly initialized parameters).')
    if not os.path.isdir(config.resume_from):
        raise FileNotFoundError(config.resume_from)
    params, step = checkpoint.load_last_params(config.resume_from)
    missing = [name for name in ('eye_net', 'refine_net')
               if name not in params
               and (name == 'eye_net' or spec.refine_net_enabled)]
    if missing:
        raise RuntimeError('checkpoint %d of %s has no %s parameters'
                           % (step, config.resume_from, ' + '.join(missing)))
    if not spec.refine_net_enabled:
        params = {'eye_net': params['eye_net']}
    logger.info('Serving checkpoint %d of %s', step, config.resume_from)
    return spec, convert.eve_state_dict(params)


def main(argv=None):
    import torch

    from eve_tpu_torch.serve import ServingEngine, make_http_server

    config, args = parse_config(argv)
    # cuDNN runs float32 convolutions in TF32 by default (about three
    # decimal digits); the port serves float32, so TF32 is off.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    engine_kw = dict(
        device=args.device,
        mesh=config.serve_num_devices if config.serve_num_devices > 1 else None,
        device_resident=config.serve_device_resident,
        max_batch=config.serve_max_batch,
        max_delay_ms=config.serve_max_delay_ms,
        max_queue=config.serve_max_queue,
        request_timeout_s=config.serve_request_timeout_s,
        max_sessions=config.serve_max_sessions,
        session_ttl_s=config.serve_session_ttl_s)
    if engine_kw['mesh']:
        logger.info('serving data-parallel over %d devices',
                    config.serve_num_devices)
    if config.serve_artifact:
        logger.info('serving from AOT artifact %s', config.serve_artifact)
        engine = ServingEngine(artifact=config.serve_artifact, **engine_kw)
    else:
        spec, params = model_setup(config)
        engine = ServingEngine(spec, params, **engine_kw)
    server = make_http_server(
        engine, host=config.serve_host, port=config.serve_port,
        max_body_bytes=config.serve_max_body_mb * 1024 * 1024)
    logger.info('serving on http://%s:%d (device=%s, max_batch=%d, '
                'max_delay=%.1fms)', *server.server_address, args.device,
                engine.max_batch, config.serve_max_delay_ms)

    # SIGTERM: stop accepting (503), let accepted requests finish, exit. The
    # drain runs on a helper thread: server.shutdown() deadlocks when called
    # from the thread inside serve_forever.
    def _drain_and_shutdown():
        engine.drain()
        server.shutdown()

    def _on_sigterm(signum, frame):
        logger.warning('SIGTERM: draining in-flight requests, then '
                       'shutting down')
        threading.Thread(target=_drain_and_shutdown, daemon=True,
                         name='eve-serving-drain').start()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        # Resolve every pending future first so handler threads blocked in
        # engine.infer() return, then join the handlers.
        engine.stop()
        server.server_close()


if __name__ == '__main__':
    main()
