"""One rank of tests/test_torch_port_distributed.py, launched as torchrun
would launch it (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK
in the environment), on the CPU with gloo, with JAX blocked:

    python tests/torch_port_dist_worker.py JOB.pkl OUT.pkl

JOB.pkl (written by the test) holds the configs, the JAX-shaped params,
the global batch and the dataset. The rank joins the group through
``init_distributed``, gathers a payload with ``all_gather_pickled``,
takes one ``make_bucket_train_step`` step on its interleaved share of
the global batch (DistributedDataParallel), saves a checkpoint, and
evaluates the dataset through ``inference``. OUT.pkl gets what it saw.
"""

import pickle
import sys

for _blocked in ("jax", "flax", "paa_tpu"):
    sys.modules[_blocked] = None


def _with_pos_mask(loss):
    def call(*args, **kwargs):
        out, aux = loss(*args, return_aux=True, **kwargs)
        return {**out, "pos_mask": aux["pos_mask"]}
    return call


def _cfg(overrides):
    from paa_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_list(overrides)
    cfg.freeze()
    return cfg


def main(job_path, out_path):
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from paa_tpu_torch.data.coco import COCODataset
    from paa_tpu_torch.engine import TrainState
    from paa_tpu_torch.engine.inference import inference
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.solver import make_optimizer
    from paa_tpu_torch.utils import comm, load_jax_params
    from paa_tpu_torch.utils.checkpoint import Checkpointer

    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    device = comm.init_distributed("cpu")
    rank, world = comm.get_rank(), comm.get_world_size()
    out = {"rank": rank, "world": world, "device": str(device),
           "backend": dist.get_backend()}
    out["gathered"] = comm.all_gather_pickled(
        {"rank": rank, "items": list(range(rank + 3)),
         "array": np.arange(rank + 1)})

    cfg = _cfg(job["train_overrides"])
    model = build_detection_model(cfg, device=device)
    load_jax_params(model.module, job["params"])
    loss_call, loss_cfg = model.loss_fn()
    model.loss_fn = lambda: (_with_pos_mask(loss_call), loss_cfg)
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    batch = {k: v[rank::world] for k, v in job["batch"].items()}
    step = model.make_bucket_train_step(tuple(job["batch"]["images"]
                                              .shape[1:3]))
    metrics = step(state, batch)
    out["ddp"] = isinstance(state.module, DistributedDataParallel)
    out["pos_mask"] = metrics.pop("pos_mask").numpy()
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["params"] = {n: p.detach().numpy().copy()
                     for n, p in model.module.named_parameters()}
    Checkpointer(job["ckpt_dir"]).save("model_ddp", state, iteration=1)
    comm.synchronize()

    ecfg = _cfg(job["eval_overrides"])
    emodel = build_detection_model(ecfg, device=device, seed=1)
    load_jax_params(emodel.module, job["params"])
    dataset = COCODataset(job["ann_file"], job["img_dir"], False)
    out["eval"] = inference(ecfg, emodel, dataset,
                            output_folder=job["eval_dir"])
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(out, f)
    comm.synchronize()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
