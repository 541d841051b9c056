"""Configuration for the PyTorch port: model, heatmap, training, serving keys.

A copy of the keys of ``eve_tpu``'s config that the port reads (the model
spec, the heatmaps, training and the ``serve_*`` keys), with the same
defaults and the same override semantics: JSON files apply in order, CLI
flags override them, unknown keys and badly typed values raise, and an int
is accepted where a float is expected. So ``configs/eye_net.json`` and
``configs/refine_net.json`` load unchanged. ``learning_rate`` is derived,
``batch_size * base_learning_rate``; setting it is type-checked and has no
effect, as in eve_tpu.

Keys that ``eve_tpu`` knows but the port does not read yet fall in two
groups (see ROADMAP.md):

- ``DEFERRED_KEYS`` (the dataset reader, evaluation, export, images): a
  JSON file may set them and they are ignored, because nothing the port
  runs depends on them;
- ``UNIMPLEMENTED_KEYS`` (training options of later slices): they raise
  ``NotImplementedError`` when set to anything but their default, so a run
  never silently differs from the one its config describes.

A key in no set raises, so a typo still fails loudly. Unlike ``eve_tpu``'s
singleton, every ``Config()`` is a fresh object that the caller creates and
passes.
"""

import json
import logging
import os

logger = logging.getLogger(__name__)

# Keys of eve_tpu's config that the port accepts and ignores until the
# slice that uses them lands (see ROADMAP.md). ``tpu_use_pallas`` stays
# here for good: the port always launches its kernels on a CUDA tensor.
DEFERRED_KEYS = frozenset((
    'gaze_history_map_decay_per_ms', 'tpu_native_refine_head',
    'tpu_native_stem', 'assumed_frame_rate', 'camera_frame_type',
    'codalab_eval_batch_size', 'codalab_eval_data_workers', 'datasrc_eve',
    'export_batch_size', 'export_path', 'export_streaming', 'eyes_size',
    'face_size', 'frame_cache_dir', 'frame_cache_gb', 'full_test_batch_size',
    'full_test_data_workers', 'inference_streaming', 'input_path',
    'load_full_frame_for_visualization', 'max_sequence_len', 'note',
    'output_path', 'prefetch_buffer_size', 'test_cameras', 'test_stimuli',
    'tpu_compile_cache_dir', 'tpu_coordinator_address', 'tpu_num_devices',
    'tpu_num_processes', 'tpu_on_device_preprocess', 'tpu_process_id',
    'tpu_use_pallas', 'train_cameras', 'train_stimuli',
    'use_native_framepack', 'video_decoder_codec',
))

# Training options of later slices, with eve_tpu's defaults: any other
# value raises (NotImplementedError) instead of being ignored.
UNIMPLEMENTED_KEYS = {
    'train_batch_echoing': 1,
    'tpu_remat': 'none',
    'tpu_sequence_shards': 1,
    'tpu_model_parallelism': 1,
    'tpu_multihost': False,
    'profile_dir': '',
    'gsheet_secrets_json_file': '',
    'gsheet_workbook_key': '',
    'skip_training': False,
    'auto_resume': False,
}


def _normalize_remat(value):
    """eve_tpu's ``tpu_remat`` spellings of "off" -> 'none'."""
    if value is False or (isinstance(value, str) and
                          value.lower() in ('false', 'no', 'n', '0')):
        return 'none'
    return value


class Config:
    """Typed parameters with JSON and dict overrides.

    Precedence: class defaults -> JSON files (in the order given) -> dict or
    CLI overrides.
    """

    # Data shapes the model sees
    screen_size = [128, 72]  # width, height
    actual_screen_size = [1920, 1080]  # DO NOT CHANGE
    load_screen_content = False

    # Run directory to load weights from, or to resume training
    resume_from = ''

    # Training
    identifier_suffix = ''
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

    # Checkpoints: a periodic save every N steps, the newest N kept; the
    # periodic saves write on a background thread after a host snapshot.
    checkpoints_save_every_n_steps = 100
    checkpoints_keep_n = 3
    tpu_async_checkpoint = True

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

    # Compute type of the networks: 'float32' (bfloat16 is a later slice).
    tpu_compute_dtype = 'float32'
    # The opt-in TPU-native topology is a later slice; the key is read so
    # that a config which sets it fails loudly.
    tpu_native_arch = False
    # Reference quirk: a CLSTM bottleneck carries only its state.
    reference_compat_clstm_carry_only = True

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
        """Import a JSON config file, overriding existing entries."""
        if not os.path.isfile(json_path):
            raise FileNotFoundError(json_path)
        logger.info('Loading %s', json_path)
        with open(json_path, 'r') as f:
            self.import_dict(json.load(f))

    def import_dict(self, dictionary):
        """Import key/value pairs, with strict type agreement checks."""
        for key, value in dictionary.items():
            if key in DEFERRED_KEYS:
                logger.debug('Ignoring key %s (not used by the port yet)', key)
                continue
            if key in UNIMPLEMENTED_KEYS:
                if key == 'tpu_remat':
                    value = _normalize_remat(value)
                if value != UNIMPLEMENTED_KEYS[key]:
                    raise NotImplementedError(
                        '%s=%r: the port implements only %r so far; see '
                        'ROADMAP.md' % (key, value, UNIMPLEMENTED_KEYS[key]))
                continue
            if not hasattr(type(self), key):
                raise ValueError('Unknown configuration key: ' + key)
            expected = type(getattr(self, key))
            if expected is float and type(value) is int:
                value = float(value)
            elif expected is not type(value):
                raise TypeError(
                    'Type mismatch for key "%s": expected %s, got %s'
                    % (key, expected.__name__, type(value).__name__))
            if not isinstance(vars(type(self)).get(key), property):
                setattr(self, key, value)

    def override(self, key, value):
        self.import_dict({key: value})
