"""Configuration for the PyTorch port: the model, heatmap and serving keys.

A copy of the keys of ``eve_tpu``'s config that the serving slice reads
(the model spec, the heatmaps and the ``serve_*`` keys), with the same
defaults and the same override semantics: JSON files apply in order, CLI
flags override them, unknown keys and badly typed values raise, and an int
is accepted where a float is expected. So ``configs/refine_net.json`` loads
unchanged.

Keys that ``eve_tpu`` knows but this port does not use yet (training, data,
evaluation, export, the TPU mesh) are listed in ``DEFERRED_KEYS``: a JSON
file may set them, and they are ignored. A key in neither set raises, so a
typo still fails loudly.

Unlike ``eve_tpu``'s singleton, every ``Config()`` is a fresh object that
the caller creates and passes.
"""

import json
import logging
import os

logger = logging.getLogger(__name__)

# Keys of eve_tpu's config that the port accepts and ignores until the
# slice that uses them lands (see ROADMAP.md). ``tpu_use_pallas`` stays
# here for good: the port always launches its kernels on a CUDA tensor.
DEFERRED_KEYS = frozenset((
    'eye_net_frozen', 'fully_reproducible', 'gaze_history_map_decay_per_ms',
    'refine_net_do_offset_augmentation',
    'refine_net_offset_augmentation_sigma',
    'refine_net_offset_augmentation_zero_prob', 'tpu_native_refine_head',
    'tpu_native_stem', 'tpu_remat',
    'assumed_frame_rate', 'auto_resume', 'base_learning_rate', 'batch_size',
    'camera_frame_type', 'checkpoints_keep_n',
    'checkpoints_save_every_n_steps', 'codalab_eval_batch_size',
    'codalab_eval_data_workers', 'datasrc_eve', 'do_gradient_clipping',
    'export_batch_size', 'export_path', 'export_streaming',
    'eye_net_learning_rate_multiplier', 'eye_net_load_pretrained',
    'eyes_size', 'face_size', 'frame_cache_dir', 'frame_cache_gb',
    'full_test_batch_size', 'full_test_data_workers',
    'gradient_accumulation_steps', 'gradient_clip_amount', 'gradient_clip_by',
    'gsheet_secrets_json_file', 'gsheet_workbook_key', 'identifier_suffix',
    'inference_streaming', 'input_path', 'learning_rate',
    'load_full_frame_for_visualization', 'log_every_n_steps',
    'lr_decay_epoch_interval', 'lr_decay_factor', 'lr_decay_strategy',
    'max_sequence_len', 'note', 'num_epochs', 'num_warmup_epochs',
    'output_path', 'prefetch_buffer_size', 'profile_dir',
    'reference_compat_lr_schedule', 'refine_net_learning_rate_multiplier',
    'refine_net_load_pretrained', 'skip_training',
    'tensorboard_images_every_n_steps',
    'tensorboard_learning_rate_every_n_steps',
    'tensorboard_scalars_every_n_steps', 'test_batch_size', 'test_cameras',
    'test_data_workers', 'test_every_n_steps', 'test_num_samples',
    'test_stimuli', 'tpu_async_checkpoint', 'tpu_compile_cache_dir',
    'tpu_coordinator_address', 'tpu_model_parallelism', 'tpu_multihost',
    'tpu_num_devices', 'tpu_num_processes', 'tpu_on_device_preprocess',
    'tpu_process_id', 'tpu_sequence_shards', 'tpu_use_pallas',
    'train_batch_echoing', 'train_cameras', 'train_data_workers',
    'train_stimuli', 'use_native_framepack', 'video_decoder_codec',
    'weight_decay',
))


class Config:
    """Typed parameters with JSON and dict overrides.

    Precedence: class defaults -> JSON files (in the order given) -> dict or
    CLI overrides.
    """

    # Data shapes the model sees
    screen_size = [128, 72]  # width, height
    actual_screen_size = [1920, 1080]  # DO NOT CHANGE
    load_screen_content = False

    # Run directory to load weights from
    resume_from = ''

    # Eye gaze network
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
        """Names of every configuration key, sorted."""
        return sorted(k for k, v in vars(cls).items()
                      if not k.startswith('_') and not callable(v)
                      and not isinstance(v, classmethod))

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
            if not hasattr(type(self), key):
                raise ValueError('Unknown configuration key: ' + key)
            expected = type(getattr(self, key))
            if expected is float and type(value) is int:
                value = float(value)
            elif expected is not type(value):
                raise TypeError(
                    'Type mismatch for key "%s": expected %s, got %s'
                    % (key, expected.__name__, type(value).__name__))
            setattr(self, key, value)

    def override(self, key, value):
        self.import_dict({key: value})
