"""Tensor and sequence parallelism (the mesh's "model" axis) on the CPU.

One module fixture spawns 2 gloo ranks at tp = 2 (dp = 1; ``file://``
rendezvous under tmp_path, one thread a rank) and one process for each
training config's JAX record and one-process port step, while the test
process runs JAX's serving; the ranks wait for the inputs those write:

  * the rule table: the port shards a parameter iff JAX's ``param_spec(path,
    shape, 2)`` shards its counterpart, along the same dimension, for every
    parameter of ``tiny_test_config()`` with a narrow ViT (so that the ViT's
    rules are reached) and of its own-encoder MaskDINO variant; each
    parameter's counterpart is found through the export's name map (JAX's
    leaves filled with their index along the sharded dimension, exported);
  * serving: the tiny config with a narrow ViT (64 wide, 4 heads, 4 blocks),
    f32, one 128x128 image with a padded band, through JAX's unsharded
    ``apply`` + ``hipie_inference`` and through the port cut to tp = 2, with
    and without ``shard_tokens``: the encoder memory, the decoder outputs
    slot-aligned (as tests/test_torch_slice.py aligns them) and the inference
    result within rtol 1e-4 / atol 1e-5; and ``shard_tokens`` where JAX's
    rules leave the VL layer and the FFNs whole (one VL head, an odd FFN
    width) against the whole model without it, within 1e-4 of scale;
  * training: a step at test_torch_train_common's config (ResNet-18, batch
    2) and at it with the narrow ViT (whose rel-pos tables each rank meets
    with its own heads only) on both ranks (they take the same batch and the
    same draws: dp = 1), with and without ``shard_tokens``, from JAX's
    training parameters (``jax_loss_record``) with JAX's keys and point picks.
    Held against the one-process port step on the same inputs: every loss
    term within 1e-5 relative, the gradients the optimizer gets (the shards
    gathered) within 3e-5 relative norm (a gradient under 1e-5 of the largest
    is held to 3e-5 of the largest), the same clipped norm, and the ranks'
    replicated parameters bit-identical after the update. Held against JAX's
    single-device loss and gradient at test_torch_train_step's limits: terms
    1e-4 relative, gradients 1e-3 relative norm (under 1e-5 of the largest:
    1e-5 of the largest);
  * checkpoints: the one-process state's checkpoint restored at tp = 2 gives
    each rank its slices bit for bit, and saved again at tp = 2 it is the
    same file's tensors, bit for bit, restored at tp = 1 again;
  * the entry points: ``train_net`` (2 steps, a checkpoint, the inline
    evaluation) and ``eval_net`` on ``make_tiny_coco``'s fixture with
    ``--tp 2`` on the ranks (the rank body ``launch`` runs: the ranks are up
    already), and the refusals of ``--tp`` that does not divide the ranks and
    of tp > 1 without a process group.

The dry run's tensor-parallel, sequence-parallel and sharded-inference legs
run in tests/test_torch_parallel.py's spawn (``dryrun_multigpu(2)`` takes
tp = 2 there).
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import concurrent.futures
import os
import re

import numpy as np
import pytest
import torch

import hipie_tpu.config as jconfig
import hipie_torch.config as tconfig
from test_torch_train_common import (JaxKeys, batch_arrays, jax_loss_record, port_model_from_jax,
                                     torch_batch, train_config)

TP = 2
NARROW = (64, 4, 4, 0.0)
B, H, W, L, C = 1, 128, 128, 16, 5
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-5
TERM_RTOL, GRAD_RTOL = 1e-5, 3e-5
JAX_TERM_RTOL, JAX_GRAD_RTOL = 1e-4, 1e-3
# the training configs: test_torch_train_common's, and it with the narrow ViT
ARCHS = {"resnet": {},
         "vit": {"model.backbone.name": "vit_narrow", "model.backbone.vit_img_size": 96,
                 "model.backbone.vit_window_size": 4, "model.still_cls_for_encoder": True}}


def serve_config(pkg=tconfig, **extra):
    return pkg.apply_overrides(pkg.tiny_test_config(), {
        "model.backbone.name": "vit_narrow", "model.backbone.vit_img_size": 128,
        "model.backbone.vit_window_size": 4, "model.still_cls_for_encoder": True, **extra})


def serve_inputs():
    r = np.random.RandomState(0)
    img = r.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    pad = np.zeros((B, H, W), bool)
    pad[:, 96:, :] = True
    ids = (np.arange(L)[None] % 16).astype(np.int32)
    am = np.ones((B, L), np.int32)
    sizes = np.array([[96, 128]], np.int32)
    return img, pad, ids, am, sizes


def class_maps():
    mw = np.zeros((C, L), np.float32)
    tm = np.zeros((C, L), bool)
    for c in range(C):
        mw[c, 2 * c + 1] = 1.0
        tm[c, 2 * c + 1] = True
    return mw, tm, np.array([True, True, False, False, True])


def _narrow_vit():
    import hipie_torch.models.backbone.vit as tvit

    tvit.VIT_VARIANTS["vit_narrow"] = NARROW


def _recording_step(state, cfg, coords=None):
    """make_train_step with each step's weighted loss terms and the gradients
    the optimizer gets (whole tensors: a rank's shards gathered) recorded, and
    the mask losses' point picks recorded (``coords`` None) or replayed
    (test_torch_parallel.point_picks: near-tied uncertain points may swap
    between two f32 runs; the comparison holds the step, not the ties)."""
    import hipie_torch.train.step as step_module
    from hipie_torch.parallel.tensor import gather_shard, tp_plan
    from test_torch_parallel import point_picks

    coords, (module, name, picks) = point_picks(coords)
    rec = {"terms": [], "grads": {}, "coords": coords}
    plan = tp_plan(state.model)
    named = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
    opt_step, apply_weights = state.optimizer.step, step_module.apply_weight_dict

    def optimizer_step():
        for n, p in named:
            g = p.grad.detach() if p.grad is not None else torch.zeros_like(p)
            rec["grads"][n] = gather_shard(g, *plan[n]) if n in plan else g.clone()
        return opt_step()

    def weights(losses, lc):
        rec["terms"].append({k: float(v.detach()) for k, v in losses.items()})
        return apply_weights(losses, lc)

    state.optimizer.step = optimizer_step
    step = step_module.make_train_step(cfg, state, device="cpu")

    def run(batch, keys):
        step_module.apply_weight_dict = weights
        real_picks = getattr(module, name)
        setattr(module, name, picks)
        try:
            _, metrics = step(state, batch, keys)
        finally:
            step_module.apply_weight_dict = apply_weights
            setattr(module, name, real_picks)
        rec["grad_norm"] = float(metrics["grad_norm"])
        return rec

    return run


def _keys():
    import jax

    return JaxKeys(jax.random.PRNGKey(1))


def one_process_step(work, arch):
    """JAX's loss record at the training config of ``arch``, then the
    one-process port step from its parameters with its keys and point picks
    (the reference of the ranks' steps). Writes what the ranks take
    (``train_{arch}.pt``) and, for ResNet, the stepped state's checkpoint,
    which the ranks restore at tp = 2. Returns (JAX record, port record)."""
    from hipie_torch.train.checkpoint import save_checkpoint
    from hipie_torch.train.step import create_train_state

    want, params = jax_loss_record(batch_arrays(), **ARCHS[arch])
    cfg = train_config(**ARCHS[arch])
    model, _ = port_model_from_jax(params, cfg)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    coords = [torch.from_numpy(np.array(c)) for c in want["coords"]]
    state = create_train_state(cfg, device="cpu", model=model)
    rec = _recording_step(state, cfg, coords)(torch_batch(batch_arrays()), _keys())
    if arch == "resnet":
        save_checkpoint(work, state, 1, name="tp1")
    _publish({"weights": weights, "coords": coords}, os.path.join(work, f"train_{arch}.pt"))
    return want, rec


def _publish(obj, path):
    """torch.save, seen by ``_wait_for`` only once it is whole."""
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _reference_step(work, arch):
    """``one_process_step`` in a process of its own, beside the test process's
    serving run and the other config's (each JAX record is a compile of a
    minute)."""
    import hipie_tpu.models.backbone.vit as jvit

    jvit.VIT_VARIANTS["vit_narrow"] = NARROW
    _narrow_vit()
    return one_process_step(work, arch)


def _wait_for(work, name):
    """``work/name`` once the test process has written it."""
    import time

    path, waited = os.path.join(work, name), 0.0
    while not os.path.exists(path):
        if os.path.exists(os.path.join(work, "abort")) or waited > 900:
            raise RuntimeError("the test process's side failed")
        time.sleep(0.1)
        waited += 0.1
    return torch.load(path, weights_only=True)


def _tiny_yaml(work):
    """The tiny training config (2 steps, a checkpoint and an evaluation of one
    image at step 2) as the YAML the entry points read, and its dataset root."""
    import dataclasses

    from hipie_torch.config import HIPIEConfig
    from hipie_torch.tools import make_tiny_coco

    root = os.path.join(work, "data")
    make_tiny_coco.main(["--root", root, "--n-train", "2", "--n-val", "2", "--size", "128"])
    cfg = train_config(**{"data.crop_size": 128, "data.max_text_len": 16,
                          "data.min_size_test": 96, "data.max_size_test": 128,
                          "data.train_datasets": ["coco_panoptic_train"],
                          "data.dataset_ratios": [1.0], "data.test_dataset": "coco_panoptic_val",
                          "test.test_size": [128, 128], "solver.ims_per_batch": 2,
                          "solver.max_iter": 2, "solver.checkpoint_period": 2,
                          "test.eval_period": 2, "test.eval_max_images": 1})

    def diff(a, b):
        return {k: (diff(v, b[k]) if isinstance(v, dict) else v) for k, v in a.items()
                if v != b[k]}

    def lines(d, ind=0):
        for k, v in d.items():
            if isinstance(v, dict):
                yield " " * ind + f"{k}:"
                yield from lines(v, ind + 2)
            elif isinstance(v, (list, tuple)):
                yield " " * ind + f"{k}: [{', '.join(str(x) for x in v)}]"
            else:
                yield " " * ind + f"{k}: {v}"

    path = os.path.join(work, "tiny.yaml")
    with open(path, "w") as f:
        f.write("\n".join(lines(diff(dataclasses.asdict(cfg), dataclasses.asdict(HIPIEConfig())))))
    return path, root


def _rank(rank: int, work: str) -> None:
    """One rank of the tp = 2 grid: serving, the entry points, training (once
    the test process has written its inputs) and checkpoints; writes what the
    tests read to ``rank{rank}.pt``."""
    from hipie_torch.models.hipie import HIPIEModel, hipie_inference
    from hipie_torch.models.postprocess import ClassMaps
    from hipie_torch.parallel.mesh import (COLLECTIVES, create_mesh, init_distributed,
                                           model_rank, shutdown_distributed)
    from hipie_torch.parallel.tensor import shard_module_, take_shard, tp_plan
    from hipie_torch.tools import eval_net, train_net
    from hipie_torch.train.checkpoint import full_state, restore_checkpoint, save_checkpoint
    from hipie_torch.train.step import create_train_state

    torch.set_num_threads(1)
    init_distributed("gloo", f"file://{os.path.join(work, 'rendezvous')}", rank=rank,
                     world_size=TP)
    out = {}
    try:
        mesh = create_mesh(tp=TP)
        out["grid"] = (mesh.dp, mesh.tp, model_rank())
        _narrow_vit()
        sd = _wait_for(work, "serve_sd.pt")
        mw, tm, is_thing = class_maps()
        args = [torch.from_numpy(a) for a in serve_inputs()]
        for sp in (False, True):
            cfg = serve_config(**{"model.transformer.shard_tokens": sp})
            model = HIPIEModel(cfg.model).eval()
            model.load_state_dict(sd, strict=True)
            plan = shard_module_(model)
            COLLECTIVES.clear()
            with torch.inference_mode():
                o = model(*args)
                res = hipie_inference(o, ClassMaps(*map(torch.from_numpy, (mw, tm, is_thing))),
                                      cfg.test, cfg.model,
                                      pad_mask_s4=args[1][0][::4, ::4])
            out[f"serve_{sp}"] = {
                "memory": o["memory"], "init_reference": o["init_reference"],
                "hs": o["hs"], "pred_logits": o["pred_logits"], "pred_boxes": o["pred_boxes"],
                "scores": res.scores, "classes": res.classes, "boxes": res.boxes,
                "sem_seg": res.sem_seg, "collectives": dict(COLLECTIVES)}
        out["serve_plan"] = sorted(plan)

        # shard_tokens where JAX's rules leave the VL layer and the FFNs whole
        # (one VL head, an odd FFN width): against the whole model without it
        whole_cfg = {"model.transformer.vl_nheads": 1, "model.transformer.dim_feedforward": 65}
        torch.manual_seed(0)
        whole = HIPIEModel(serve_config(**whole_cfg).model).eval()
        split = HIPIEModel(serve_config(**whole_cfg, **{
            "model.transformer.shard_tokens": True}).model).eval()
        split.load_state_dict(whole.state_dict())
        shard_module_(split)
        with torch.inference_mode():
            a, b = whole(*args), split(*args)
        enc = split.detr.detr.transformer.encoder
        out["whole_blocks"] = {
            "tp": (enc.vl_layers[0].b_attn.attn.tp, enc.layers[0].tp),
            "err": {k: float((a[k] - b[k]).abs().max()) / float(a[k].abs().max())
                    for k in ("memory", "enc_outputs_class", "pred_logits")}}

        # the entry points' rank body under --tp 2
        cfg_file, root = _tiny_yaml(work) if rank == 0 else (None, None)
        torch.distributed.barrier()
        cfg_file, root = os.path.join(work, "tiny.yaml"), os.path.join(work, "data")
        os.environ["HIPIE_DATASETS"] = root
        run = os.path.join(work, "run")
        trainer = train_net._train(["--config-file", cfg_file, "--device", "cpu", "--tp", "2",
                                    "output_dir", run], "cpu")
        out["train_net"] = {"step": trainer.state.step,
                            "loss": [float(h["total_loss"]) for h in trainer.history],
                            "eval": sorted(trainer.history[-1].get("eval", {})),
                            "sharded": bool(tp_plan(trainer.state.model))}
        torch.distributed.barrier()
        out["eval_net"] = eval_net.evaluate(eval_net.parse_args(
            ["--config-file", cfg_file, "--device", "cpu", "--tp", "2", "--weights",
             os.path.join(run, "model_0000002.pth"), "--dataset", "coco_panoptic_val",
             "--max-images", "1"]), "cpu")

        # training, from JAX's parameters with JAX's keys and point picks
        for arch, extra in ARCHS.items():
            inp = _wait_for(work, f"train_{arch}.pt")
            for sp in (False, True):
                cfg = train_config(**extra, **{"model.transformer.shard_tokens": sp})
                model = HIPIEModel(cfg.model, train=True)
                model.load_state_dict(inp["weights"], strict=True)
                state = create_train_state(cfg, device="cpu", model=model)
                rec = _recording_step(state, cfg, inp["coords"])(torch_batch(batch_arrays()),
                                                                 _keys())
                del rec["coords"]
                plan = tp_plan(state.model)
                rec["replicated"] = {n: p.detach().clone() for n, p in
                                     state.model.named_parameters() if n not in plan}
                out[f"train_{arch}_{sp}"] = rec

        # checkpoints: the one-process file at tp = 2, and saved again
        cfg = train_config()
        state = create_train_state(cfg, seed=1, device="cpu")
        restore_checkpoint(os.path.join(work, "tp1.pth"), state)
        plan = tp_plan(state.model)
        ref = torch.load(os.path.join(work, "tp1.pth"), weights_only=True)
        own = state.model.state_dict()
        out["ckpt_slices_equal"] = all(
            torch.equal(own[k], take_shard(v, *plan[k], model_rank(), TP) if k in plan else v)
            for k, v in ref["model"].items())
        moments = state.optimizer.opt.state_dict()["state"]
        out["ckpt_moments_equal"] = all(
            torch.equal(moments[i][key], take_shard(ref["optimizer"]["adamw"]["state"][i][key],
                                                    *plan[n], model_rank(), TP)
                        if n in plan else ref["optimizer"]["adamw"]["state"][i][key])
            for i, n in enumerate(state.optimizer.names) for key in ("exp_avg", "exp_avg_sq"))
        save_checkpoint(work, state, 1, name="tp2")
        out["full_state_keys"] = sorted(full_state(state)[0])
    finally:
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        shutdown_distributed()


def _jax_serving(work):
    """JAX's unsharded serving run on its own init, whose weights the ranks load."""
    import jax
    import jax.numpy as jnp

    from hipie_tpu.models.hipie import HIPIEModel as JModel
    from hipie_tpu.models.hipie import hipie_inference as j_inference
    from hipie_tpu.models.postprocess import ClassMaps as JMaps
    from hipie_tpu.models.transformer import VLDeformableTransformer
    from hipie_torch.utils.export import export_hipie_checkpoint

    jcfg = serve_config(jconfig)
    args = serve_inputs()
    mw, tm, is_thing = class_maps()
    jm = JModel(jcfg.model)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)
    sd = export_hipie_checkpoint(jax.device_get(params)["params"], serve_config())
    _publish({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
             os.path.join(work, "serve_sd.pt"))

    def run(p, *a):
        out, state = jm.apply(
            p, *a, mutable=["intermediates"],
            capture_intermediates=lambda mdl, method: (
                isinstance(mdl, VLDeformableTransformer) and method == "__call__"))
        out["memory"] = state["intermediates"]["detr"]["transformer"]["__call__"][0]["memory"]
        res = j_inference(out, JMaps(jnp.asarray(mw), jnp.asarray(tm), jnp.asarray(is_thing)),
                          jcfg.test, jcfg.model, pad_mask_s4=jnp.asarray(args[1][0][::4, ::4]))
        return out, res

    return params, jax.jit(run)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    import jax

    import hipie_torch.models.backbone.vit as tvit
    import hipie_tpu.models.backbone.vit as jvit

    work = str(tmp_path_factory.mktemp("tp"))
    with pytest.MonkeyPatch.context() as patch:
        for var in ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN"):
            patch.delenv(var, raising=False)
        patch.setitem(jvit.VIT_VARIANTS, "vit_narrow", NARROW)
        patch.setitem(tvit.VIT_VARIANTS, "vit_narrow", NARROW)
        with concurrent.futures.ThreadPoolExecutor(1) as pool, \
                concurrent.futures.ProcessPoolExecutor(len(ARCHS), mp.get_context("spawn")) as ref:
            steps = {arch: ref.submit(_reference_step, work, arch) for arch in ARCHS}
            ranks = pool.submit(mp.start_processes, _rank, args=(work,), nprocs=TP,
                                start_method="spawn")
            try:
                params, jax_run = _jax_serving(work)
                jout, jres = jax.device_get(jax_run(params, *serve_inputs()))
                train = {arch: step.result() for arch, step in steps.items()}
            except BaseException:
                open(os.path.join(work, "abort"), "w").close()  # the ranks stop waiting
                raise
            ranks.result()
    got = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(TP)]
    return work, jout, jres, train, got


def _close(got, want, name, rtol=SERVE_RTOL, atol=SERVE_ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got) else got),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=name)


# ---- the rule table against JAX's param_spec -------------------------------------

def _jax_leaf_path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


@pytest.mark.parametrize("variant", ["tiny", "vit", "own_encoder", "swin"])
def test_rules_shard_what_jax_shards(variant):
    """Every parameter is sharded by the port's plan (the modules' declared
    layouts) iff JAX's param_spec shards its counterpart at tp = 2, along the
    same dimension; a ViT qkv rank holds its share of q, k and v, every other
    sharded parameter JAX's contiguous share. The ViT's rel-pos tables are
    declared partial."""
    import jax
    import jax.numpy as jnp

    import hipie_tpu.models.backbone.vit as jvit
    from hipie_tpu.models.hipie import HIPIEModel as JModel
    from hipie_tpu.parallel.mesh import param_spec as jax_spec
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.parallel.tensor import (build_plan, take_shard, token_local_parameters,
                                             tp_layouts)
    from hipie_torch.utils.export import export_hipie_checkpoint

    extra = {"tiny": {"model.backbone.name": "resnet_tiny"}, "vit": {},
             "own_encoder": {"model.maskdino.shared_encoder": False},
             "swin": {"model.backbone.name": "swin_tiny"}}[variant]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_VARIANTS, "vit_narrow", NARROW)
        _narrow_vit()
        jcfg, cfg = serve_config(jconfig, **extra), serve_config(**extra)
        shapes = jax.eval_shape(JModel(jcfg.model).init, jax.random.PRNGKey(0),
                                *map(jnp.asarray, serve_inputs()))
        with torch.device("meta"):
            model = HIPIEModel(cfg.model)
    # each JAX leaf: its index along the dim JAX shards (+1), 0 where replicated
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    leaves, n_sharded = [], 0
    for kp, leaf in flat:
        spec = jax_spec(_jax_leaf_path(kp), leaf.shape, TP)
        dims = [i for i, a in enumerate(spec) if a == "model"]
        mark = np.zeros(leaf.shape, np.float32)
        if dims:
            n_sharded += 1
            d = dims[0]
            idx = np.arange(leaf.shape[d], dtype=np.float32) + 1
            mark += idx.reshape([-1 if i == d else 1 for i in range(len(leaf.shape))])
        leaves.append(mark)
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), leaves)
    marks = export_hipie_checkpoint(tree["params"], cfg)
    n_port, plan = 0, build_plan(model, TP)
    for name, p in model.named_parameters():
        m = torch.from_numpy(np.ascontiguousarray(marks[name]))
        spec = plan.get(name)
        varying = [d for d in range(m.dim()) if m.dim() and
                   bool((m != m.select(d, 0).unsqueeze(d)).any())]
        jax_sharded = bool(m.any())
        assert (spec is not None) == jax_sharded, name
        if spec is None:
            continue
        n_port += 1
        dim, blocks = spec
        # JAX's index varies along the torch dim the port shards (alone: a
        # 1-wide leaf does not vary at all)
        assert varying in ([dim], []), (name, varying, dim)
        for r in range(TP):
            mine = take_shard(m, dim, blocks, r, TP)
            if blocks == 1:
                # JAX's share: the contiguous run of rank r of its dim's indices
                n = float(m.max())
                assert mine.min() > r * n / TP and mine.max() <= (r + 1) * n / TP, name
            else:
                assert re.search(r"\.attn\.qkv\.", name), name
                # one block each of q, k and v: a third of this rank's rows from each
                n = m.shape[dim] // 3
                for j in range(3):
                    part = mine.narrow(dim, j * n // TP, n // TP)
                    lo = j * n + r * n // TP
                    assert part.min() > lo and part.max() <= lo + n // TP, name
    assert n_port == sum(1 for k, v in marks.items() if np.asarray(v).any()) > 0
    assert n_sharded > 0
    partial = [f"{n}.{p}" for n, _, layout in tp_layouts(model) for p in layout.partial]
    assert all(".attn.rel_pos_" in n for n in partial)
    if variant == "vit":
        assert any(".blocks.3.attn.qkv.weight" in n for n, _ in model.named_parameters())
        assert len(partial) == 2 * NARROW[2]
    # under shard_tokens only the main encoder's token-local gradients are summed
    # over the model group, never MaskDINO's own encoder's (whole on every rank)
    local = {id(p) for p in token_local_parameters(model)}
    names = [n for n, p in model.named_parameters() if id(p) in local]
    assert names and all(n.startswith("detr.detr.transformer.encoder.") for n in names)


# ---- serving ---------------------------------------------------------------------------

def _slot_perm(jout, tout):
    ref = np.asarray(jout["init_reference"])[0]
    ours = tout["init_reference"].numpy()[0]
    perm = np.abs(ref[:, None, :] - ours[None, :, :]).max(-1).argmin(1)
    assert len(set(perm.tolist())) == len(perm), "slot alignment is not bijective"
    return perm


@pytest.mark.parametrize("shard_tokens", [False, True])
def test_tp2_serving_equals_jax(runs, shard_tokens):
    """Both ranks' f32 forward at tp = 2 (with and without shard_tokens)
    against JAX's unsharded apply on the same weights."""
    _, jout, jres, _, got = runs
    for r in range(TP):
        t = got[r][f"serve_{shard_tokens}"]
        perm = _slot_perm(jout, t)
        _close(t["memory"], jout["memory"], "memory")
        _close(t["init_reference"][:, perm], jout["init_reference"], "init_reference")
        _close(t["hs"][:, :, perm], jout["hs"], "decoder hs")
        _close(t["pred_logits"][:, perm], jout["pred_logits"], "pred_logits")
        _close(t["pred_boxes"][:, perm], jout["pred_boxes"], "pred_boxes")
        for name in ("scores", "boxes", "sem_seg"):
            _close(t[name], getattr(jres, name), name)
        np.testing.assert_array_equal(t["classes"].numpy(), np.asarray(jres.classes))
    for g in got:
        # shard_tokens with whole VL and FFN blocks: the replicated path
        assert g["whole_blocks"]["tp"] == (1, 1)
        assert max(g["whole_blocks"]["err"].values()) <= SERVE_RTOL, g["whole_blocks"]
    one, two = (got[0][f"serve_{s}"]["collectives"]["all_reduce_model"] for s in (False, True))
    # 4 ViT blocks x 2, the VL layer 2, the FFNs of 2 encoder, 2 decoder and 2
    # MaskDINO decoder layers; shard_tokens: MSDA's 2 value gathers, the
    # encoder FFNs' and VL layer's gathers beside their reduce-scatters, the memory
    assert (one, two) == (16, 22)
    assert got[0]["grid"] == (1, 2, 0) and got[1]["grid"] == (1, 2, 1)


# ---- training ----------------------------------------------------------------------------

@pytest.mark.parametrize("shard_tokens", [False, True])
def test_tp2_train_step_equals_one_process(runs, shard_tokens):
    _, _, _, train, got = runs
    for arch, (_, one) in train.items():
        for r in range(TP):
            rec = got[r][f"train_{arch}_{shard_tokens}"]
            assert len(rec["terms"]) == len(one["terms"])
            for a, b in zip(rec["terms"], one["terms"]):
                assert a.keys() == b.keys()
                for k in a:
                    assert abs(a[k] - b[k]) <= TERM_RTOL * max(abs(b[k]), 1e-8), (arch, k)
            assert rec["grads"].keys() == one["grads"].keys()
            largest = max(float(g.norm()) for g in one["grads"].values())
            for n, want in one["grads"].items():
                err = float((rec["grads"][n] - want).norm())
                # a gradient that vanishes in exact arithmetic carries round-off alone
                scale = largest if float(want.norm()) < 1e-5 * largest else float(want.norm())
                assert err <= GRAD_RTOL * scale, (arch, n, err, float(want.norm()))
            assert abs(rec["grad_norm"] - one["grad_norm"]) <= TERM_RTOL * one["grad_norm"]
        for n, p in got[0][f"train_{arch}_{shard_tokens}"]["replicated"].items():
            assert torch.equal(p, got[1][f"train_{arch}_{shard_tokens}"]["replicated"][n]), n


@pytest.mark.parametrize("shard_tokens", [False, True])
def test_tp2_train_step_equals_jax(runs, shard_tokens):
    """Both ranks' loss terms and gathered gradients against JAX's
    single-device loss and gradient on the same parameters, batch, keys and
    point picks, at test_torch_train_step's limits; the ViT's rel-pos tables
    among the gradients held."""
    _, _, _, train, got = runs
    for arch, (want, _) in train.items():
        largest = max(np.linalg.norm(w) for w in want["grads"].values())
        for r in range(TP):
            rec = got[r][f"train_{arch}_{shard_tokens}"]
            assert len(rec["terms"]) == len(want["terms"]) == 2
            for a, w in zip(rec["terms"], want["terms"]):
                assert set(a) == set(w)
                for k in w:
                    wk = float(w[k])
                    assert abs(a[k] - wk) <= JAX_TERM_RTOL * max(abs(wk), 1e-6), (arch, k)
            held = []
            for n, g in rec["grads"].items():
                w = want["grads"][n].astype(np.float64)
                g = g.numpy().astype(np.float64)
                if np.linalg.norm(w) < 1e-5 * largest:
                    assert np.linalg.norm(g - w) <= 1e-5 * largest, (arch, n)
                    continue
                err = np.linalg.norm(g - w) / np.linalg.norm(w)
                assert err <= JAX_GRAD_RTOL, (arch, n, err)
                held.append(n)
            assert len(held) > 200, (arch, len(held))
            if arch == "vit":
                assert sum(".attn.rel_pos_" in n for n in held) == 2 * NARROW[2]


# ---- checkpoints -------------------------------------------------------------------------

def test_checkpoint_reshards_between_tp2_and_tp1(runs):
    from hipie_torch.train.checkpoint import restore_checkpoint
    from hipie_torch.train.step import create_train_state

    work, _, _, _, got = runs
    assert all(g["ckpt_slices_equal"] and g["ckpt_moments_equal"] for g in got)
    tp1 = torch.load(os.path.join(work, "tp1.pth"), weights_only=True)
    tp2 = torch.load(os.path.join(work, "tp2.pth"), weights_only=True)
    assert tp1["model"].keys() == tp2["model"].keys() == set(got[0]["full_state_keys"])
    for k, v in tp1["model"].items():
        assert torch.equal(v, tp2["model"][k]), k
    for i, st in tp1["optimizer"]["adamw"]["state"].items():
        for key, v in st.items():
            assert torch.equal(v, tp2["optimizer"]["adamw"]["state"][i][key]), (i, key)
    # and the tp = 2 file restores at tp = 1
    state = create_train_state(train_config(), seed=3, device="cpu")
    restore_checkpoint(os.path.join(work, "tp2.pth"), state)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, tp1["model"][k]), k


# ---- the entry points ----------------------------------------------------------------

def test_train_net_and_eval_net_take_tp(runs):
    _, _, _, _, got = runs
    for g in got:
        tn = g["train_net"]
        assert tn["step"] == 2 and tn["sharded"] and all(np.isfinite(tn["loss"]))
        assert "panoptic/PQ" in tn["eval"]
        assert g["eval_net"]["images"] == 1 and np.isfinite(g["eval_net"]["panoptic/PQ"])
    assert got[0]["train_net"]["loss"] == got[1]["train_net"]["loss"]
    np.testing.assert_equal(got[0]["eval_net"], got[1]["eval_net"])      # NaN == NaN here


def test_tp_refusals():
    """--tp that does not divide the ranks, and tp > 1 without a process
    group, raise: there is no fallback to one process."""
    from hipie_torch.parallel import mesh
    from hipie_torch.tools import eval_net, train_net

    with pytest.raises(ValueError, match="tp=2 does not divide the 1 ranks"):
        train_net.main(["--device", "cpu", "--tp", "2"])
    with pytest.raises(ValueError, match="tp=2 does not divide the 3 ranks"):
        eval_net.main(["--device", "cpu", "--num-gpus", "3", "--tp", "2"])
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh.create_mesh(tp=2)
    assert mesh.model_size() == 1 and mesh.model_rank() == 0
