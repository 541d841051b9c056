"""Dataset constants: participant splits, stimulus parsing, source rates.

A copy of ``eve_tpu/data/specs.py``, the reference's constants
(src/datasources/common.py:33-47, src/datasources/eve_sequences.py:38-48).
"""

predefined_splits = {
    'train': ['train%02d' % i for i in range(1, 40)],
    'val': ['val%02d' % i for i in range(1, 6)],
    'test': ['test%02d' % i for i in range(1, 11)],
    'etc': ['etc%02d' % i for i in range(1, 3)],
}

source_to_fps = {
    'screen': 30,
    'basler': 60,
    'webcam_l': 30,
    'webcam_c': 30,
    'webcam_r': 30,
}

source_to_interval_ms = {
    source: 1e3 / fps for source, fps in source_to_fps.items()
}

CAMERAS = ('basler', 'webcam_l', 'webcam_c', 'webcam_r')
SOURCES = ('screen',) + CAMERAS


def stimulus_type_from_folder_name(folder_name):
    parts = folder_name.split('_')
    if parts[1] in ('image', 'video', 'wikipedia'):
        return parts[1]
    elif parts[1] == 'eye':
        return 'points'
    raise ValueError('Given folder name unexpected: %s' % folder_name)
