"""OpenPose skeleton label maps (port of
``imaginaire_tpu/utils/visualization/pose.py``).

OpenPose JSON (25 body, 70 face and 2 x 21 hand keypoints a person,
each (x, y, confidence)) is decoded into a dict of keypoint groups a
person (``openpose_to_npy``; ``openpose_to_npy_largest_only`` keeps the
tallest skeleton), moved through the augmentation with the images, and
rendered (``draw_openpose_npy``, a ``vis::`` op) into label maps of the
canvas's size: 3 colored channels, or with ``for_pose_dataset.pose_one_hot``
27 one-hot channels (one a body edge, 24 with the feet; left hand 24,
right hand 25, face 26). Keypoints below their group's confidence
threshold are dropped. Each edge is drawn unless a draw of the item's
``rng`` falls at or under ``random_drop_prob`` (the JAX package draws
from the global ``random``, in the same order). Strokes reuse the face
renderer's curve fit and rasterizer (``utils/visualization/face.py``).
Host-side numpy.
"""

from __future__ import annotations

import random

import numpy as np

from imaginaire_tpu_torch.config import cfg_get
from imaginaire_tpu_torch.utils.visualization.face import draw_edge, interp_points

THRESHOLDS = {"pose": 0.15, "face": 0.5, "hand_l": 0.3, "hand_r": 0.3}
GROUPS = ("pose", "face", "hand_l", "hand_r")
OPENPOSE_KEYS = {"pose": "pose_keypoints_2d", "face": "face_keypoints_2d",
                 "hand_l": "hand_left_keypoints_2d", "hand_r": "hand_right_keypoints_2d"}
ONE_HOT_CHANNELS = 27


def define_edge_lists(basic_points_only=False):
    """(pose edges, their colors, hand chains, their colors, face chains)."""
    pose_edge_list = [
        [17, 15], [15, 0], [0, 16], [16, 18],   # head
        [0, 1], [1, 8],                         # torso
        [1, 2], [2, 3], [3, 4],                 # right arm
        [1, 5], [5, 6], [6, 7],                 # left arm
        [8, 9], [9, 10], [10, 11],              # right leg
        [8, 12], [12, 13], [13, 14],            # left leg
    ]
    pose_color_list = [
        [153, 0, 153], [153, 0, 102], [102, 0, 153], [51, 0, 153],
        [153, 0, 51], [153, 0, 0],
        [153, 51, 0], [153, 102, 0], [153, 153, 0],
        [102, 153, 0], [51, 153, 0], [0, 153, 0],
        [0, 153, 51], [0, 153, 102], [0, 153, 153],
        [0, 102, 153], [0, 51, 153], [0, 0, 153],
    ]
    if not basic_points_only:
        pose_edge_list += [[11, 24], [11, 22], [22, 23],
                           [14, 21], [14, 19], [19, 20]]  # feet
        pose_color_list += [[0, 153, 153]] * 3 + [[0, 0, 153]] * 3
    hand_edge_list = [[0, 1, 2, 3, 4], [0, 5, 6, 7, 8], [0, 9, 10, 11, 12],
                      [0, 13, 14, 15, 16], [0, 17, 18, 19, 20]]
    hand_color_list = [[204, 0, 0], [163, 204, 0], [0, 204, 82],
                       [0, 82, 204], [163, 0, 204]]
    face_list = [
        [list(range(0, 17))],
        [list(range(17, 22))],
        [list(range(22, 27))],
        [[28, 31], list(range(31, 36)), [35, 28]],
        [[36, 37, 38, 39], [39, 40, 41, 36]],
        [[42, 43, 44, 45], [45, 46, 47, 42]],
        [list(range(48, 55)), [54, 55, 56, 57, 58, 59, 48]],
    ]
    return (pose_edge_list, pose_color_list, hand_edge_list, hand_color_list,
            face_list)


def extract_valid_keypoints(pts):
    """[pose, face, hand_l, hand_r] (N, 2) xy of one person's groups, a
    keypoint under its group's confidence threshold set to (0, 0)."""
    out = []
    for name in GROUPS:
        p = np.asarray(pts.get(name, np.zeros((0, 3))), np.float32)
        if p.size:
            p = p[:, :2] * (p[:, 2] > THRESHOLDS[name])[:, None]
        else:
            p = np.zeros((0, 2), np.float32)
        out.append(p)
    return out


def draw_edges(canvas, keypoints, edges_list, bw, use_one_hot, random_drop_prob=0,
               edge_len=2, colors=None, draw_end_points=False, rng=None):
    """Draw each edge (``edge_len`` keypoints at a time along each chain)
    whose keypoints are all valid, unless ``rng`` drops it; with
    ``use_one_hot`` chain list k goes to channel k."""
    rng = random if rng is None else rng
    k = 0
    for edge_list in edges_list:
        for i, edge in enumerate(edge_list):
            for j in range(0, max(1, len(edge) - 1), edge_len - 1):
                if rng.random() > random_drop_prob:
                    sub = list(edge)[j:j + edge_len]
                    x, y = keypoints[sub, 0], keypoints[sub, 1]
                    if 0 not in x:  # zeroed keypoints are invalid
                        cx, cy = interp_points(x, y)
                        if use_one_hot:
                            draw_edge(canvas[:, :, k], cx, cy, bw=bw, color=255,
                                      draw_end_points=draw_end_points)
                        else:
                            color = colors[i] if colors is not None else (255, 255, 255)
                            draw_edge(canvas, cx, cy, bw=bw, color=color,
                                      draw_end_points=draw_end_points)
            k += 1
    return canvas


def connect_pose_keypoints(pts, edge_lists, size, basic_points_only=False,
                           remove_face_labels=False, random_drop_prob=0.0, rng=None):
    """One person's [pose, face, hand_l, hand_r] keypoints -> a uint8
    (h, w, c) canvas; c > 3 is the one-hot layout. Strokes are
    ``max(1, span // 150)`` pixels for the body and ``span // 450`` for
    hands and face, ``span`` the body's vertical extent."""
    pose_pts, face_pts, hand_pts_l, hand_pts_r = pts
    h, w, c = size
    canvas = np.zeros((h, w, c), np.uint8)
    use_one_hot = c > 3
    (pose_edge_list, pose_color_list, hand_edge_list, hand_color_list,
     face_list) = edge_lists
    span = int(pose_pts[:, 1].max() - pose_pts[:, 1].min()) if pose_pts.size else h
    bw = max(1, span // 150)
    draw_edges(canvas, pose_pts, [pose_edge_list], bw, use_one_hot, random_drop_prob,
               colors=pose_color_list, draw_end_points=True, rng=rng)
    if not basic_points_only:
        bw = max(1, span // 450)
        for i, hand_pts in enumerate([hand_pts_l, hand_pts_r]):
            if hand_pts.size:
                if use_one_hot:
                    draw_edges(canvas[:, :, 24 + i], hand_pts, [hand_edge_list], bw,
                               False, random_drop_prob,
                               colors=[255] * len(hand_edge_list), rng=rng)
                else:
                    draw_edges(canvas, hand_pts, [hand_edge_list], bw, False,
                               random_drop_prob, colors=hand_color_list, rng=rng)
        if not remove_face_labels and face_pts.size:
            draw_edges(canvas[:, :, 26] if use_one_hot else canvas, face_pts, face_list,
                       bw, False, random_drop_prob, rng=rng)
    return canvas


def openpose_to_npy(inputs, return_largest_only=False):
    """Decoded OpenPose JSON -> a list of person dicts of (N, 3) float32
    groups (or the tallest person's dict alone: the largest vertical
    extent of its body keypoints over confidence 0.1), None without
    people. A frame list maps frame by frame; a bare people list is one
    frame."""
    if isinstance(inputs, list):
        if not (inputs and isinstance(inputs[0], dict) and "pose_keypoints_2d" in inputs[0]):
            return [openpose_to_npy(f, return_largest_only) for f in inputs]
        people = inputs
    else:
        people = inputs.get("people", [])
    decoded = [{name: np.asarray(person.get(key, []), np.float32).reshape(-1, 3)
                for name, key in OPENPOSE_KEYS.items()} for person in people]
    if not decoded:
        return None
    if return_largest_only:
        def height(e):
            valid = e["pose"][e["pose"][:, 2] > 0.1]
            return float(np.ptp(valid[:, 1])) if valid.size else 0.0

        return max(decoded, key=height)
    return decoded


def openpose_to_npy_largest_only(inputs):
    return openpose_to_npy(inputs, return_largest_only=True)


def draw_openpose_npy(resize_h, resize_w, crop_h, crop_w, original_h, original_w,
                      is_flipped, cfgdata, keypoints_npy, rng=None):
    """Each frame's people (keypoints already in canvas coordinates: the
    augmentation moved them) -> a (resize_h, resize_w, 3 or 27) float32
    map in [0, 1], the people's maps maxed; a frame with no one is
    zeros."""
    pose_cfg = cfg_get(cfgdata, "for_pose_dataset", None) or {}
    basic_points_only = cfg_get(pose_cfg, "basic_points_only", False)
    remove_face_labels = cfg_get(pose_cfg, "remove_face_labels", False)
    random_drop_prob = cfg_get(pose_cfg, "random_drop_prob", 0.0)
    c = ONE_HOT_CHANNELS if cfg_get(pose_cfg, "pose_one_hot", False) else 3
    edge_lists = define_edge_lists(basic_points_only)
    outputs = []
    for frame in keypoints_npy:
        label = np.zeros((resize_h, resize_w, c), np.float32)
        if frame is not None:
            for person in (frame if isinstance(frame, list) else [frame]):
                one = connect_pose_keypoints(
                    extract_valid_keypoints(person), edge_lists, (resize_h, resize_w, c),
                    basic_points_only, remove_face_labels, random_drop_prob, rng=rng)
                label = np.maximum(label, one.astype(np.float32) / 255.0)
        outputs.append(label)
    return outputs
