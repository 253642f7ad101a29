"""Faults planted under the timed path, for the tests that see ``correct``
come out false: each one a way a later change could break what the cells
measure while still running."""

import torch


class Fault:
    def __init__(self):
        self._undo = []

    def patch(self, obj, name, fn):
        inner = getattr(obj, name)
        setattr(obj, name, fn(inner))
        self._undo.append(lambda: setattr(obj, name, inner))

    def remove(self):
        while self._undo:
            self._undo.pop()()


class ServeHalfBatch(Fault):
    """The model serves the first half of a request's images and answers the
    rest with their outputs."""

    def install(self):
        from hipie_torch.models.hipie import HIPIEModel

        def fn(inner):
            def forward(self, images, pad_mask, input_ids, lang_attn_mask, image_sizes, **kw):
                h = images.shape[0] // 2
                kw = {k: v[:h] if torch.is_tensor(v) and v.dim() and v.shape[0] == images.shape[0]
                      else v for k, v in kw.items()}
                out = inner(self, images[:h], pad_mask[:h], input_ids[:h], lang_attn_mask[:h],
                            image_sizes[:h], **kw)
                return _repeat(out, images.shape[0] // h)
            return forward
        self.patch(HIPIEModel, "forward", fn)


def _repeat(x, n):
    if isinstance(x, dict):
        return {k: _repeat(v, n) for k, v in x.items()}
    if torch.is_tensor(x) and x.dim() >= 1:
        return torch.cat([x] * n)
    return x


class ServeAlteredAnswer(Fault):
    """Post-processing names the next class for every detection."""

    def install(self):
        import hipie_torch.models.hipie as hipie

        def fn(inner):
            def hipie_inference(*a, **kw):
                res = inner(*a, **kw)
                return res._replace(classes=(res.classes + 1) % res.sem_seg.shape[0])
            return hipie_inference
        self.patch(hipie, "hipie_inference", fn)


class TrainStateUnchanged(Fault):
    """The optimizer's step returns without updating anything."""

    def install(self):
        from hipie_torch.train.optimizer import GroupedAdamW

        def fn(inner):
            def step(self):
                self.updates += 1
                return torch.zeros((), device=self.params[0].device)
            return step
        self.patch(GroupedAdamW, "step", fn)


class TrainHalfBatch(Fault):
    """The loss leaves out the second half of the batch's images (their GTs
    dropped) and takes its mean over the rest."""

    def install(self):
        import hipie_torch.train.step as step_mod

        def fn(inner):
            def make_loss_fn(*a, **kw):
                loss_fn = inner(*a, **kw)

                def half(batch, keys):
                    t = batch.targets
                    keep = torch.arange(t.valid.shape[0], device=t.valid.device) < t.valid.shape[0] // 2
                    return loss_fn(batch._replace(targets=t._replace(valid=t.valid & keep[:, None])),
                                   keys)
                return half
            return make_loss_fn
        self.patch(step_mod, "make_loss_fn", fn)
