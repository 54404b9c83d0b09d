"""Training engine: epoch loop, eval cadence, early stopping, JSON logs
(counterpart of ``fastegnn_tpu/train/loop.py``).

The control flow is the JAX package's (reference ``utils/train.py:181-226``):
validate and test every ``test_interval`` epochs, keep the best-validation
checkpoint, early-stop after ``early_stop`` epochs without improvement, and
rewrite a JSON log ``[best_log_dict, log_dict]`` every epoch.  The logged
per-epoch loss is the pure MSE.  Checkpoints hold the model, the optimizer
state, the step and the epoch, and ``resume_from`` continues from one.
Besides the best-validation checkpoint, the loop saves the last epoch's
with the best and log dicts, from which ``resume_from`` goes on as the
uninterrupted run would have (log, best epoch and early stop included).

Each step gets a host key made from ``(seed, tag, epoch, i)``
(:func:`step_key`), so its MMD draw does not depend on what ran before it.
The per-step losses stay on the device; each epoch reads them back once.
Beside the JAX log's keys, ``log_dict["telemetry"]`` keeps per epoch the
wall seconds, the median interval between train step completions
(:class:`StepTimer`, so the waits for batches count), the steps and,
on a card, the peak device memory.

Under data or graph parallelism (``train_step_fn`` / ``batch_iter_fn`` /
``agree_fn`` of ``parallel/data_parallel.py``, and ``eval_step_fn`` /
``eval_batch_iter_fn`` of ``parallel/owner_graph.py``) every rank runs this loop;
the caller that owns the process group turns printing, the log, the
checkpoints and the trace off on the ranks other than 0.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Optional

import numpy as np
import torch

from fastegnn_tpu_torch.data.batcher import GraphDataset
from fastegnn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from fastegnn_tpu_torch.train.step import make_eval_step, make_train_step
from fastegnn_tpu_torch.utils.profiling import StepTimer, profile_trace


def step_key(seed: int, tag: int, epoch: int, i: int) -> np.ndarray:
    """Raw uint32[2] key of one step, made on the host (SeedSequence
    mixing); the JAX loop's ``_step_key``."""
    return np.random.SeedSequence((seed, tag, epoch, i)).generate_state(2, np.uint32)


def _mean(losses) -> float:
    """The mean of a list of device scalars, read back once."""
    return float(torch.stack(losses).double().mean())


def _run_epoch_train(train_step, batches, seed, epoch, timer):
    losses = []
    timer.start()
    for i, batch in enumerate(batches):
        losses.append(train_step(batch, step_key(seed, 0, epoch, i))["mse"])
        timer.stop()
    return _mean(losses), len(losses)


def _run_epoch_eval(eval_step, batches, seed, epoch):
    losses = [eval_step(batch, step_key(seed, 1, epoch, i))["mse"]
              for i, batch in enumerate(batches)]
    return _mean(losses)


def train(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    dataset_train: GraphDataset,
    dataset_valid: GraphDataset,
    dataset_test: GraphDataset,
    *,
    batch_size: int,
    sigma: float,
    weight: float,
    sample: int = 3,
    per_graph_sampling: bool = False,
    use_mmd: bool = True,
    test_interval: int = 5,
    early_stop: float = float("inf"),
    max_epochs: int = 1_000_000,
    seed: int = 43,
    log_directory: Optional[str] = None,
    log_name: str = "train_log.json",
    ckpt_directory: Optional[str] = None,
    resume_from: Optional[str] = None,
    verbose: bool = True,
    profile_trace_dir: Optional[str] = None,
    train_step_fn=None,
    eval_step_fn=None,
    batch_iter_fn=None,
    eval_batch_iter_fn=None,
    agree_fn=None,
    shuffle: bool = True,
):
    """Train ``model`` in place; returns ``(best_log_dict, log_dict, step)``.

    ``resume_from``: a checkpoint saved by this loop; restores the model,
    the optimizer state, the step and the epoch and continues with the next
    epoch.  As in the JAX loop, the shuffle generator starts afresh from
    ``seed``, so after a resume the batches differ from an uninterrupted
    run's unless ``shuffle=False``.  A ``last`` checkpoint also restores
    the best and log dicts and the seconds already run.

    ``ckpt_directory``: save ``best`` at every better validation loss, and
    ``last`` at the end of every epoch that does not stop the run.

    ``use_mmd``: add the MMD term to the training loss (the Fast* family;
    VNEGNN trains on the MSE alone).

    ``train_step_fn`` / ``eval_step_fn``: steps ``step(graph, key)`` in
    place of the default ones.  ``batch_iter_fn(dataset, batch_size,
    rng=...)``: the training batches in place of ``dataset.iter_batches``
    (this rank's sub-batches under data parallelism; evaluation stays on
    whole batches).  ``eval_batch_iter_fn(dataset, batch_size)``: the
    validation and test batches in place of ``dataset.iter_batches`` (this
    rank's shards under graph parallelism, where ``eval_step_fn`` is the
    owner-sharded eval step).  ``agree_fn(loss_valid, loss_test)``: the two losses
    that the best-epoch and early-stop decisions read (rank 0's on every
    rank under data parallelism).  ``profile_trace_dir``: trace the second
    epoch of this run with :func:`profile_trace`.
    """
    device = next(model.parameters()).device
    batch_iter_fn = batch_iter_fn or (lambda ds, bs, rng: ds.iter_batches(bs, rng=rng))
    eval_batch_iter_fn = eval_batch_iter_fn or (lambda ds, bs: ds.iter_batches(bs, rng=None))
    train_step = train_step_fn or make_train_step(
        model, optimizer, sigma, weight, sample, per_graph_sampling, use_mmd)
    eval_step = eval_step_fn or make_eval_step(
        model, sigma, weight, sample, per_graph_sampling, use_mmd)
    # shuffle=False: the same batches in the same order every epoch (the
    # reference N-body / protein loaders never shuffle), so they are
    # collated once and kept
    shuffle_rng = np.random.default_rng(seed) if shuffle else None
    for ds in (dataset_valid, dataset_test) + (() if shuffle else (dataset_train,)):
        ds.enable_collate_cache()

    log_dict = {"epochs": [], "loss": [], "loss_train": [], "telemetry": []}
    best = {"epoch_index": 0, "loss_valid": 1e8, "loss_test": 1e8, "loss_train": 1e8}
    start = time.perf_counter()

    step, start_epoch = 0, 1
    if resume_from is not None:
        ck = restore_checkpoint(resume_from, map_location=device)
        model.load_state_dict(ck["model"])
        optimizer.load_state_dict(ck["optimizer"])
        step, start_epoch = int(ck["step"]), int(ck["epoch"]) + 1
        if "log" in ck:
            best, log_dict = ck["best"], ck["log"]
            start -= ck["seconds"]
        if verbose:
            print(f"resumed from {resume_from} at epoch {start_epoch}, step {step}",
                  flush=True)

    timer = StepTimer(device)
    for epoch in range(start_epoch, max_epochs + 1):
        t_epoch = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        args = (train_step, batch_iter_fn(dataset_train, batch_size, rng=shuffle_rng),
                seed, epoch, timer)
        if profile_trace_dir is not None and epoch == start_epoch + 1:
            # the second epoch: the first one pays the kernels' first launches
            with profile_trace(profile_trace_dir):
                loss_train, n_steps = _run_epoch_train(*args)
            if verbose:
                print(f"profiler trace written to {profile_trace_dir}", flush=True)
        else:
            loss_train, n_steps = _run_epoch_train(*args)
        step += n_steps
        step_ms = timer.step_ms()
        log_dict["loss_train"].append(loss_train)
        if verbose:
            print(f"train epoch: {epoch}, avg loss: {loss_train:.5f}", flush=True)

        if epoch % test_interval == 0:
            loss_valid = _run_epoch_eval(eval_step, eval_batch_iter_fn(dataset_valid, batch_size),
                                         seed, epoch)
            loss_test = _run_epoch_eval(eval_step, eval_batch_iter_fn(dataset_test, batch_size),
                                        seed, epoch + 10_000_000)
            # every rank must take the best-epoch and early-stop decisions
            # below alike, or a rank that went on would wait in the next
            # step's all_reduce until the group's timeout; each rank's eval
            # of the same parameters on the same batches can still differ in
            # its last bits on the card (float atomics), so they all decide
            # on one rank's losses
            if agree_fn is not None:
                loss_valid, loss_test = agree_fn(loss_valid, loss_test)
            log_dict["epochs"].append(epoch)
            log_dict["loss"].append(loss_test)
            if verbose:
                print(f"==> valid epoch: {epoch}, avg loss: {loss_valid:.5f}\n"
                      f"==> test epoch: {epoch}, avg loss: {loss_test:.5f}", flush=True)

            if loss_valid < best["loss_valid"]:
                best = {"epoch_index": epoch, "loss_valid": loss_valid,
                        "loss_test": loss_test, "loss_train": loss_train}
                if ckpt_directory is not None:
                    save_checkpoint(os.path.join(ckpt_directory, "best"),
                                    {"model": model.state_dict(),
                                     "optimizer": optimizer.state_dict(),
                                     "step": step, "epoch": epoch})
            if verbose:
                print(f"*** Best Valid Loss: {best['loss_valid']:.5f} | "
                      f"Best Test Loss: {best['loss_test']:.5f} | "
                      f"Best Epoch Index: {best['epoch_index']}", flush=True)

        telemetry = {
            "epoch": epoch, "seconds": time.perf_counter() - t_epoch, "steps": n_steps,
            "step_ms_median": statistics.median(step_ms) if step_ms else None,
            "peak_device_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                                if device.type == "cuda" else None)}
        log_dict["telemetry"].append(telemetry)
        if verbose:
            print(f"epoch {epoch} telemetry: {telemetry}", flush=True)
        if epoch % test_interval == 0 and epoch - best["epoch_index"] >= early_stop:
            best["early_stop"] = epoch
            if verbose:
                print(f"Early stopped! Epoch: {epoch}", flush=True)
            break

        best["time_cost"] = time.perf_counter() - start
        if log_directory is not None:
            os.makedirs(log_directory, exist_ok=True)
            with open(os.path.join(log_directory, log_name), "w") as f:
                json.dump([best, log_dict], f, indent=4)
        if ckpt_directory is not None:
            save_checkpoint(os.path.join(ckpt_directory, "last"),
                            {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                             "step": step, "epoch": epoch, "best": best, "log": log_dict,
                             "seconds": best["time_cost"]})

    return best, log_dict, step
