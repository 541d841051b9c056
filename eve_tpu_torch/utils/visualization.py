"""PoG overlay drawing and video encoding for inference output.

A copy of ``eve_tpu/utils/visualization.py``, the reference visualizer
(src/inference.py:59-254): fixation circles (initial = yellow, refined =
green, Tobii GT = red), error lines to GT, legend text, inset eye patches,
all drawn on the 1080p screen recording, streamed to an mp4 at 10 fps.
Encoding uses an ffmpeg pipe when the binary exists, else OpenCV's
VideoWriter. ``cv2`` is imported where it draws or encodes, so the package
imports on a machine without OpenCV.
"""

import shutil
import subprocess

import numpy as np

def _cv2():
    """OpenCV, imported on first use."""
    try:
        import cv2
    except ImportError as exc:
        raise ImportError('drawing the PoG overlay needs OpenCV (the cv2 '
                          'module), which is not installed') from exc
    return cv2


# BGR colors as in the reference (src/inference.py:148-157)
COLOR_INITIAL = [0, 180, 180]   # yellow
COLOR_FINAL = [0, 180, 0]       # green
COLOR_GT = [0, 0, 180]          # red


def draw_pog_overlay(frame_bgr, to_draw, eyes_bgr=None, draw_gt_lines=True,
                     gt=None, gt_validity=None, t=0, ui_scale=1.0):
    """Draw one frame's overlay in place.

    Args:
      frame_bgr: (H, W, 3) uint8 screen frame (modified in place).
      to_draw: list of (label, PoG (T, 2), validity (T,), color_bgr).
      eyes_bgr: optional eye-strip image to inset bottom-right.
      ui_scale: scales the fixed-size UI elements (legend, radii, inset),
        whose reference dimensions assume a 1920-wide canvas. 1.0 on real
        EVE recordings.
    """
    cv2 = _cv2()

    def s(v, lo=1):
        return max(lo, int(round(v * ui_scale)))

    if eyes_bgr is not None:
        eyes = cv2.resize(eyes_bgr, (s(256), s(128)))
        eh, ew, _ = eyes.shape
        frame_bgr[-eh:, -ew:, :] = np.fliplr(eyes)

    if draw_gt_lines and gt is not None and gt_validity is not None \
            and gt_validity[t]:
        x_gt, y_gt = int(gt[t, 0]), int(gt[t, 1])
        for label, pog, validity, color in to_draw:
            if 'Groundtruth' in label or not validity[t]:
                continue
            x, y = int(pog[t, 0]), int(pog[t, 1])
            cv2.line(frame_bgr, (x, y), (x_gt, y_gt), color=[0, 0, 0],
                     thickness=s(5), lineType=cv2.LINE_AA)
            cv2.line(frame_bgr, (x, y), (x_gt, y_gt), color=color,
                     thickness=s(2), lineType=cv2.LINE_AA)

    for _, pog, validity, color in to_draw:
        if not validity[t]:
            continue
        x, y = int(pog[t, 0]), int(pog[t, 1])
        cv2.circle(frame_bgr, (x, y), radius=s(14), color=[0, 0, 0],
                   thickness=-1, lineType=cv2.LINE_AA)
        cv2.circle(frame_bgr, (x, y), radius=s(10), color=color,
                   thickness=-1, lineType=cv2.LINE_AA)

    offset_dy = 0
    for label, _, _, color in to_draw:
        org = (s(50), s(90) + offset_dy)
        cv2.putText(frame_bgr, label, org=org,
                    fontFace=cv2.FONT_HERSHEY_DUPLEX,
                    fontScale=1.6 * ui_scale,
                    color=[0, 0, 0], thickness=s(9), lineType=cv2.LINE_AA)
        cv2.putText(frame_bgr, label, org=org,
                    fontFace=cv2.FONT_HERSHEY_DUPLEX,
                    fontScale=1.6 * ui_scale,
                    color=color, thickness=s(2), lineType=cv2.LINE_AA)
        offset_dy += s(80)
    return frame_bgr


class VideoEncoder:
    """Streaming mp4 encoder (ffmpeg pipe preferred, cv2 fallback)."""

    def __init__(self, output_path, fps=10):
        self.output_path = output_path
        self.fps = fps
        self._proc = None
        self._writer = None
        self._size = None

    def write(self, frame_bgr):
        h, w = frame_bgr.shape[:2]
        if self._proc is None and self._writer is None:
            self._size = (w, h)
            ffmpeg = shutil.which('ffmpeg')
            if ffmpeg:
                self._proc = subprocess.Popen(
                    [ffmpeg, '-y', '-f', 'rawvideo', '-pix_fmt', 'bgr24',
                     '-s', '%dx%d' % (w, h), '-framerate', str(self.fps),
                     '-i', 'pipe:', '-pix_fmt', 'yuv420p',
                     '-r', str(self.fps), '-loglevel', 'quiet',
                     self.output_path],
                    stdin=subprocess.PIPE)
            else:
                cv2 = _cv2()
                self._writer = cv2.VideoWriter(
                    self.output_path, cv2.VideoWriter_fourcc(*'mp4v'),
                    self.fps, self._size)
        # copy=False: callers already pass uint8; a plain astype would
        # memcpy every frame of the encode hot loop for nothing.
        frame_u8 = np.ascontiguousarray(frame_bgr.astype(np.uint8,
                                                         copy=False))
        if self._proc is not None:
            self._proc.stdin.write(frame_u8.tobytes())
        else:
            self._writer.write(frame_u8)

    def close(self):
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait()
        if self._writer is not None:
            self._writer.release()
