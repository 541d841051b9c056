"""Configuration for the PyTorch port: model, heatmap, training, serving keys.

A copy of the keys of ``eve_tpu``'s config that the port reads (the model
spec, the heatmaps, training and the ``serve_*`` keys), with the same
defaults and the same override semantics: JSON files apply in order, CLI
flags override them, unknown keys and badly typed values raise, and an int
is accepted where a float is expected. So ``configs/eye_net.json`` and
``configs/refine_net.json`` load unchanged. ``learning_rate`` is derived,
``batch_size * base_learning_rate``; setting it is type-checked and has no
effect, as in eve_tpu.

Every key of eve_tpu's is read, except the ``DEFERRED_KEYS`` (host-side
packing and caches, see ROADMAP.md): a JSON file may set them and they
are ignored, because nothing the port runs depends on
them. ``use_native_framepack`` stays there for good: the port's dataset
reader always emits uint8 frames, which the model normalises on the
device, so there is no host-side float packing to switch. For the same
reason the reader ignores ``tpu_on_device_preprocess``; the export CLI
reads it, as eve_tpu's does, to give the artifact uint8 frames.

The mesh and multi-host start-up are read: ``tpu_num_devices``,
``serve_num_devices``, ``tpu_model_parallelism``, ``tpu_sequence_shards``,
``tpu_multihost``, ``tpu_coordinator_address``, ``tpu_num_processes``
(hosts) and ``tpu_process_id`` (this host's index), with eve_tpu's
meanings and defaults (``eve_tpu_torch.parallel.mesh``); the grid's
errors are eve_tpu's (``train.harness.training_grid``).

``tpu_remat`` takes eve_tpu's values: 'none', 'eye', 'refine', 'all', or a
boolean or its command-line spelling ('all' or 'none'); anything else
raises ``ValueError``.

A key in no set raises, so a typo still fails loudly. Unlike ``eve_tpu``'s
singleton, every ``Config()`` is a fresh object that the caller creates and
passes. ``write_file_contents`` records a run's provenance as eve_tpu's
does: ``configs/combined.json``, every imported JSON file under its own
name, and ``src.zip`` of the package's sources.
"""

import glob
import json
import logging
import os
import sys
import zipfile

logger = logging.getLogger(__name__)

# Keys of eve_tpu's config that the port accepts and ignores until the
# slice that uses them lands (see ROADMAP.md). ``tpu_use_pallas`` stays
# here for good: the port always launches its kernels on a CUDA tensor.
DEFERRED_KEYS = frozenset((
    'note', 'prefetch_buffer_size',
    'tpu_compile_cache_dir', 'tpu_use_pallas', 'use_native_framepack',
))

# Keys the port reads that eve_tpu's config does not have.
PORT_KEYS = frozenset(('gaze_net',))

_REMAT_MODES = ('none', 'eye', 'refine', 'all')


def _normalize_remat(value):
    """eve_tpu's ``tpu_remat`` normalisation: a boolean or its command-line
    spelling -> 'all' or 'none'; a mode name -> itself (lower case); any
    other value raises, so that a typo such as 'eyes' cannot silently turn
    rematerialisation off."""
    if isinstance(value, bool):
        return 'all' if value else 'none'
    if isinstance(value, str):
        low = value.lower()
        if low in ('true', 'yes', 'y', '1'):
            return 'all'
        if low in ('false', 'no', 'n', '0'):
            return 'none'
        if low in _REMAT_MODES:
            return low
    raise ValueError(
        'Invalid tpu_remat value %r: expected one of %s (or a boolean)'
        % (value, list(_REMAT_MODES)))


class Config:
    """Typed parameters with JSON and dict overrides.

    Precedence: class defaults -> JSON files (in the order given) -> dict or
    CLI overrides.
    """

    # Data source: the root of the EVE dataset
    datasrc_eve = '/path/to/eve/dataset'

    # Data loading (the reader decodes on the host with ffmpeg or cv2)
    video_decoder_codec = 'libx264'  # only libx264 is decoded
    assumed_frame_rate = 10  # Frames are skipped from source videos accordingly
    max_sequence_len = 30  # In frames assuming 10 Hz
    face_size = [256, 256]  # width, height
    eyes_size = [128, 128]  # width, height
    screen_size = [128, 72]  # width, height
    actual_screen_size = [1920, 1080]  # DO NOT CHANGE
    camera_frame_type = 'eyes'  # full | face | eyes
    load_screen_content = False
    load_full_frame_for_visualization = False

    train_cameras = ['basler', 'webcam_l', 'webcam_c', 'webcam_r']
    train_stimuli = ['image', 'video', 'wikipedia']
    test_cameras = ['basler', 'webcam_l', 'webcam_c', 'webcam_r']
    test_stimuli = ['image', 'video', 'wikipedia']

    # Inference: the input video and the overlay video written
    input_path = ''
    output_path = ''
    # Carry the recurrent state across consecutive clips of the input video
    # (cli/inference.py) instead of resetting it at every clip.
    inference_streaming = False

    # Codalab evaluation (cli/eval_codalab.py)
    codalab_eval_batch_size = 128
    codalab_eval_data_workers = 1

    # Devices of the data-parallel mesh; 0 = all. Training runs one worker
    # process a device (cli/train.py starts them); evaluation replicates
    # the model over the devices in one process.
    tpu_num_devices = 0

    # The training grid's model and seq axes (parallel/mesh.py): the model
    # axis places the large parameters' slices and their Adam moments over
    # its ranks; the seq axis splits each clip's frames over its ranks and
    # hands the recurrences' carry between them (parallel/temporal.py); it
    # must divide max_sequence_len. Both claim their ranks before the data
    # axis. 1 = off.
    tpu_model_parallelism = 1
    tpu_sequence_shards = 1

    # Multi-host training (parallel/mesh.py initialize_multihost): the
    # coordinator is host 0's 'address:port', tpu_num_processes counts the
    # hosts and tpu_process_id is this host's index; every host starts its
    # own workers, one a device.
    tpu_multihost = False
    tpu_coordinator_address = ''
    tpu_num_processes = 0
    tpu_process_id = -1

    # Run directory to load weights from, or to resume training
    resume_from = ''

    # Decode-once disk cache of the training windows' frames
    # (data/framecache.py), shared with eve_tpu; '' disables. Least-recently
    # written entries are evicted beyond frame_cache_gb GiB.
    frame_cache_dir = ''
    frame_cache_gb = 20.0

    # Training
    identifier_suffix = ''
    # Evaluate only: build the model (and resume), skip the training loop.
    skip_training = False
    fully_reproducible = False
    batch_size = 16
    weight_decay = 0.001
    num_epochs = 10.0
    train_data_workers = 8
    log_every_n_steps = 1
    tensorboard_scalars_every_n_steps = 1
    tensorboard_images_every_n_steps = 10
    tensorboard_learning_rate_every_n_steps = 100
    base_learning_rate = 0.0005
    # Data echoing: each loaded batch is trained on this many times (each
    # time with fresh kappa draws).
    train_batch_echoing = 1
    # torch.profiler trace of loop steps +5..+10 into this directory ('' off).
    profile_dir = ''

    @property
    def learning_rate(self):
        """batch_size * base_learning_rate (the linear-scaling rule)."""
        return self.batch_size * self.base_learning_rate

    # LR schedule: 'none' | 'exponential' | 'cyclic'
    num_warmup_epochs = 0.0
    lr_decay_strategy = 'none'
    lr_decay_factor = 0.5
    lr_decay_epoch_interval = 0.5
    # Reference quirk: the schedule's absolute LR is also multiplied by the
    # initial LR (a LambdaLR factor); see train/optim.py.
    reference_compat_lr_schedule = False
    # Per-submodule LR multipliers (one Adam parameter group each).
    eye_net_learning_rate_multiplier = 1.0
    refine_net_learning_rate_multiplier = 1.0

    # Gradient clipping: 'norm' (global, over the trainable parameters) or
    # 'value'
    do_gradient_clipping = True
    gradient_clip_by = 'norm'
    gradient_clip_amount = 5.0
    # Average the gradients of N micro-batches (batch_size / N clips each)
    # before one clip and one optimizer update.
    gradient_accumulation_steps = 1

    # Evaluation during training (live validation)
    test_num_samples = 128
    test_batch_size = 128
    test_data_workers = 0
    test_every_n_steps = 500
    # The final full test (harness.do_final_full_test)
    full_test_batch_size = 128
    full_test_data_workers = 4

    # Checkpoints: a periodic save every N steps, the newest N kept; the
    # periodic saves write on a background thread after a host snapshot.
    checkpoints_save_every_n_steps = 100
    checkpoints_keep_n = 3
    tpu_async_checkpoint = True
    # Continue the newest run directory of the same config hash that holds
    # a checkpoint (a restart after a preemption exit 143 with the same
    # argv), instead of starting a fresh one.
    auto_resume = False

    # Google Sheets experiment registry (train/gsheet.py); inert unless
    # both are set and gspread is installed.
    gsheet_secrets_json_file = ''
    gsheet_workbook_key = ''

    # The gaze network (models/zoo.py): 'eve' (EyeNet and RefineNet) or
    # 'gaze360' (Gaze360 on face video, camera_frame_type 'face'; the
    # evaluation path only). A key of the port's own (PORT_KEYS).
    gaze_net = 'eve'

    # Eye gaze network
    eye_net_load_pretrained = False
    eye_net_frozen = False
    eye_net_use_rnn = True
    eye_net_rnn_type = 'GRU'  # 'RNN' | 'LSTM' | 'GRU'
    eye_net_rnn_num_cells = 1
    eye_net_rnn_num_features = 128
    eye_net_static_num_features = 128
    eye_net_use_head_pose_input = True
    loss_coeff_PoG_cm_initial = 0.0
    loss_coeff_g_ang_initial = 1.0
    loss_coeff_pupil_size = 1.0

    # Conditional refine network
    refine_net_enabled = False
    refine_net_load_pretrained = False
    # Kappa offset augmentation of the initial gaze in training (degrees);
    # zero_prob is the per-clip probability of showing the true initial.
    refine_net_do_offset_augmentation = True
    refine_net_offset_augmentation_sigma = 3.0
    refine_net_offset_augmentation_zero_prob = 0.0
    refine_net_use_skip_connections = True
    refine_net_use_rnn = True
    refine_net_rnn_type = 'CGRU'  # 'CRNN' | 'CLSTM' | 'CGRU'
    refine_net_rnn_num_cells = 1
    refine_net_num_features = 64
    loss_coeff_heatmap_ce_initial = 0.0
    loss_coeff_heatmap_ce_final = 1.0
    loss_coeff_heatmap_mse_final = 0.0
    loss_coeff_PoG_cm_final = 0.001

    # Heatmaps
    gaze_heatmap_size = [128, 72]
    gaze_heatmap_sigma_initial = 10.0  # in pixels
    gaze_heatmap_sigma_history = 3.0  # in pixels
    gaze_heatmap_sigma_final = 5.0  # in pixels
    gaze_history_map_decay_per_ms = 0.999

    # Compute type of the networks: 'bfloat16' runs them in bfloat16 (the
    # parameters, optimizer state, checkpoints, geometry, losses and
    # heatmap kernels stay float32); any other value runs float32, as in
    # eve_tpu.
    tpu_compute_dtype = 'float32'
    # eve_tpu's opt-in topology (models/refine_net_tpu.py and the patchify
    # EyeNet stems): not weight-compatible with the reference topology or
    # its released weights.
    tpu_native_arch = False
    # The EyeNet stem of the opt-in topology: 'patchify' (8x8/4) or
    # 'patchify8' (8x8/8). Ignored unless tpu_native_arch is set.
    tpu_native_stem = 'patchify'
    # RefineNet's readout: 'heatmap' (the reference's) or, with
    # tpu_native_arch, 'gated' (initial + gate * (heatmap - initial) +
    # delta). With RefineNet enabled, any other value, or 'gated' without
    # tpu_native_arch, raises (eve_tpu's checks).
    tpu_native_refine_head = 'heatmap'
    # Reference quirk: a CLSTM bottleneck carries only its state.
    reference_compat_clstm_carry_only = True
    # Recompute activations in the backward pass instead of keeping them
    # (torch.utils.checkpoint, in training only): 'none', 'eye' (EyeNet's
    # ResNet features; nothing with a frozen EyeNet, which keeps no graph),
    # 'refine' (RefineNet's encoder) or 'all'. One extra forward of the
    # wrapped part for less activation memory.
    tpu_remat = 'none'

    # AOT export (cli/export_model.py): the artifact's path, its fixed
    # batch size, and whether it carries the recurrent state across chunks
    # (the streaming signature). With tpu_on_device_preprocess the
    # artifact takes uint8 frames (as the port's reader and a client send
    # them), else float32 frames in [-1, 1] (eve_tpu's default); the
    # reader ignores the key.
    export_path = ''
    export_batch_size = 1
    export_streaming = False
    tpu_on_device_preprocess = False

    # HTTP serving (serve.py); see eve_tpu_torch.serve.ServingEngine.
    serve_host = '127.0.0.1'
    serve_port = 8000
    serve_max_batch = 8
    serve_max_delay_ms = 5.0
    serve_max_queue = 64
    serve_max_body_mb = 256
    serve_request_timeout_s = 30.0
    serve_max_sessions = 1024
    serve_session_ttl_s = 600.0
    serve_num_devices = 0
    # Serve an AOT artifact (cli/export_model.py) instead of model code and
    # a checkpoint; it fixes the batch size and the one input signature.
    # Not with serve_device_resident (ValueError).
    serve_artifact = ''
    serve_device_resident = False

    @classmethod
    def keys(cls):
        """Names of every configuration key, sorted (``learning_rate``
        included)."""
        return sorted(k for k, v in vars(cls).items()
                      if not k.startswith('_') and not callable(v)
                      and not isinstance(v, classmethod))

    def get_all_key_values(self):
        """``{key: value}`` of every key, the derived one included."""
        return {k: getattr(self, k) for k in self.keys()}

    def import_json(self, json_path):
        """Import a JSON config file, overriding existing entries; its text
        is kept for ``write_file_contents``."""
        if not os.path.isfile(json_path):
            raise FileNotFoundError(json_path)
        logger.info('Loading %s', json_path)
        with open(json_path, 'r') as f:
            text = f.read()
        self.import_dict(json.loads(text))
        # Two imported files may share a basename: number the later one.
        contents = self.__dict__.setdefault('_file_contents', {})
        name = os.path.basename(json_path)
        if contents.get(name, text) != text:
            stem, ext = os.path.splitext(name)
            i = 2
            while '%s.%d%s' % (stem, i, ext) in contents:
                i += 1
            name = '%s.%d%s' % (stem, i, ext)
        contents[name] = text

    def write_file_contents(self, target_base_dir):
        """Write the run's provenance into ``target_base_dir``:
        ``configs/combined.json`` (every key's value), ``configs/config.py``
        and each imported JSON file, and ``src.zip`` holding the package's
        ``.py``, ``.json``, ``.cu`` and ``.cuh`` files and the main script."""
        target_dir = os.path.join(target_base_dir, 'configs')
        os.makedirs(target_dir, exist_ok=True)
        with open(os.path.abspath(__file__)) as f:
            outputs = {'combined.json': json.dumps(
                self.get_all_key_values(), indent=4, sort_keys=True),
                       os.path.basename(__file__): f.read()}
        outputs.update(self.__dict__.get('_file_contents', {}))
        for name, content in outputs.items():
            with open(os.path.join(target_dir, name), 'w') as f:
                f.write(content)
        package = os.path.dirname(os.path.abspath(__file__))
        zip_path = os.path.join(target_base_dir, 'src.zip')
        with zipfile.ZipFile(zip_path, 'w', zipfile.ZIP_DEFLATED) as zf:
            for ext in ('py', 'json', 'cu', 'cuh'):
                for path in sorted(glob.glob(os.path.join(
                        package, '**', '*.' + ext), recursive=True)):
                    zf.write(path, os.path.relpath(path,
                                                   os.path.dirname(package)))
            main_script = os.path.abspath(sys.argv[0]) if sys.argv else ''
            if main_script.endswith('.py') and os.path.isfile(main_script):
                zf.write(main_script, os.path.basename(main_script))
        logger.info('Written the config and sources to %s', target_base_dir)

    def import_dict(self, dictionary):
        """Import key/value pairs, with strict type agreement checks."""
        for key, value in dictionary.items():
            if key in DEFERRED_KEYS:
                logger.debug('Ignoring key %s (not used by the port yet)', key)
                continue
            if not hasattr(type(self), key):
                raise ValueError('Unknown configuration key: ' + key)
            if key == 'tpu_remat':
                value = _normalize_remat(value)
            expected = type(getattr(self, key))
            if expected is float and type(value) is int:
                value = float(value)
            elif expected is not type(value):
                raise TypeError(
                    'Type mismatch for key "%s": expected %s, got %s'
                    % (key, expected.__name__, type(value).__name__))
            if key == 'video_decoder_codec' and value not in ('libx264', ''):
                logger.warning(
                    'video_decoder_codec=%r is not supported: frames are '
                    'decoded on the host CPU (ffmpeg or cv2, the libx264 '
                    'path); the key is accepted for config compatibility '
                    'only.', value)
            if not isinstance(vars(type(self)).get(key), property):
                setattr(self, key, value)

    def override(self, key, value):
        self.import_dict({key: value})
