"""Builtin label spaces (public category lists) for demos and evaluation.

Counterpart of hipie_tpu/data/label_spaces.py (the same lists).

Replaces the reference's openseg_labels/*.txt data files for the most-used
benchmarks; arbitrary label sets still load via datasets.load_openseg_labels.
"""

COCO_80 = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

COCO_PANOPTIC_STUFF_53 = [
    "banner", "blanket", "bridge", "cardboard", "counter", "curtain",
    "door-stuff", "floor-wood", "flower", "fruit", "gravel", "house", "light",
    "mirror-stuff", "net", "pillow", "platform", "playingfield", "railroad",
    "river", "road", "roof", "sand", "sea", "shelf", "snow", "stairs", "tent",
    "towel", "wall-brick", "wall-stone", "wall-tile", "wall-wood",
    "water-other", "window-blind", "window-other", "tree-merged",
    "fence-merged", "ceiling-merged", "sky-other-merged", "cabinet-merged",
    "table-merged", "floor-other-merged", "pavement-merged", "mountain-merged",
    "grass-merged", "dirt-merged", "paper-merged", "food-other-merged",
    "building-other-merged", "rock-merged", "wall-other-merged", "rug-merged",
]

# COCO panoptic 133 = 80 things + 53 stuff.
COCO_PANOPTIC_133 = COCO_80 + COCO_PANOPTIC_STUFF_53
COCO_PANOPTIC_IS_THING = [True] * 80 + [False] * 53

PASCAL_VOC_21 = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

# Pascal-Panoptic-Parts part vocabulary used by the hierarchical demo
# (reference notebooks/Demo-Main.ipynb part label set).
PASCAL_PARTS = [
    "head", "torso", "arm", "hand", "leg", "foot", "tail", "wing", "beak",
    "horn", "ear", "eye", "nose", "mouth", "hair", "neck", "wheel", "door",
    "window", "headlight", "mirror", "engine", "body", "handlebar", "saddle",
    "plant", "pot", "screen", "frame", "coach",
]

# object words shared across part labels ("dog head"/"dog tail"), used by the
# part-mode positive-map spreading (coco_dataset_mapper_uni.py
# THINGS_CLASSES_WITH_PART).
THINGS_CLASSES_WITH_PART = [
    "person", "dog", "cat", "bird", "cow", "horse", "sheep", "aeroplane",
    "bicycle", "motorbike", "car", "bus", "train", "bottle", "pottedplant",
    "tvmonitor",
]

# Pascal-Panoptic-Parts: part-label id -> merged evaluation group (58 merged
# classes; reference register_pascal.py PASCAL_LABEL_PART_GROUP — a data
# table, reproduced verbatim) and the object classes that carry parts.
PASCAL_PART_LABEL_GROUP = {1: 1, 2: 2, 3: 3, 4: 2, 5: 4, 6: 5, 7: 6, 8: 7, 9: 6, 10: 6, 11: 6, 12: 8, 13: 9, 14: 9, 15: 10, 16: 11, 17: 11, 18: 8, 19: 12, 20: 14, 21: 13, 22: 15, 23: 15, 24: 15, 25: 15, 26: 15, 27: 15, 28: 15, 29: 15, 30: 15, 31: 15, 32: 16, 33: 15, 34: 17, 35: 18, 36: 18, 37: 18, 38: 19, 39: 19, 40: 18, 41: 20, 42: 21, 43: 22, 44: 23, 45: 24, 46: 24, 47: 24, 48: 24, 49: 23, 50: 25, 51: 25, 52: 26, 53: 27, 54: 28, 55: 29, 56: 29, 57: 29, 58: 29, 59: 29, 60: 28, 61: 30, 62: 31, 63: 32, 64: 33, 65: 34, 66: 34, 67: 34, 68: 34, 69: 33, 70: 35, 71: 35, 72: 36, 73: 34, 74: 37, 75: 38, 76: 38, 77: 38, 78: 38, 79: 37, 80: 37, 81: 39, 82: 40, 83: 41, 84: 42, 85: 41, 86: 41, 87: 41, 88: 43, 89: 44, 90: 44, 91: 44, 92: 44, 93: 44, 94: 44, 95: 44, 96: 43, 97: 43, 98: 45, 99: 46, 100: 45, 101: 47, 102: 48, 103: 47, 104: 49, 105: 50, 106: 51, 107: 52, 108: 52, 109: 52, 110: 52, 111: 52, 112: 51, 113: 53, 114: 51, 115: 54, 116: 55, 117: 55, 118: 55, 119: 55, 120: 56, 121: 57}

THINGS_CLASSES_WITH_PART = ['aeroplane', 'bicycle', 'bird', 'bottle', 'bus', 'car', 'cat', 'cow', 'dog', 'horse', 'motorbike', 'person', 'pottedplant', 'sheep', 'train', 'tvmonitor']
