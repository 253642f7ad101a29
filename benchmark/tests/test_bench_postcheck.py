"""Near-ties in post-processing: a choice within the stated margin of its
threshold or neighbour may round apart between two sound implementations and
is not a flip; one farther away is."""

import torch

from harness import postcheck


def _boxes(*xs):
    return torch.tensor([[x, 0.0, x + 1.0, 1.0] for x in xs])


def test_an_iou_at_the_threshold_is_a_tie_and_its_followers_too():
    # IoU of unit boxes shifted by d is (1 - d) / (1 + d); 0.7 at d = 0.3 / 1.7
    d = 0.3 / 1.7
    boxes = _boxes(0.0, d, 5.0, 5.0 + 0.1, 5.0 + d + 0.05)
    scores = torch.tensor([0.9, 0.8, 0.7, 0.6, 0.5])
    classes = torch.zeros(5, dtype=torch.long)
    none = torch.zeros(5, dtype=torch.bool)
    tied = postcheck.nms_ties(boxes, scores, none, classes, 0.7)
    assert tied[:2].all() and not tied[2:].any()
    # another class never suppresses, so never ties
    tied = postcheck.nms_ties(boxes, scores, none, torch.tensor([0, 1, 0, 0, 0]), 0.7)
    assert not tied.any()


def test_near_equal_scores_of_overlapping_boxes_tie():
    boxes = _boxes(0.0, 0.01, 3.0)
    classes = torch.zeros(3, dtype=torch.long)
    none = torch.zeros(3, dtype=torch.bool)
    tied = postcheck.nms_ties(boxes, torch.tensor([0.5, 0.49999, 0.4]), none, classes, 0.7)
    assert tied.tolist() == [True, True, False]
    tied = postcheck.nms_ties(boxes, torch.tensor([0.5, 0.4, 0.3]), none, classes, 0.7)
    assert not tied.any()


def test_a_renumbered_panoptic_map_is_the_same_map():
    is_thing = torch.tensor([True, False])
    classes = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    pan_a = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    valid_a = torch.tensor([True, True, False, True])
    pan_b = torch.tensor([[0, 1], [2, 2]], dtype=torch.int32)      # query 1's segment gone
    valid_b = torch.tensor([True, False, False, True])
    a = postcheck._canonical(pan_a, valid_a, classes, is_thing, 4)
    b = postcheck._canonical(pan_b, valid_b, classes, is_thing, 4)
    assert a.tolist() == [[-1, 0], [4 + 1, 3]]
    # only the lost stuff segment's pixel differs; query 3 keeps its pixel under a new id
    assert (a != b).sum() == 1 and a[1, 1] == b[1, 1] == 3
