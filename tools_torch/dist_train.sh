#!/usr/bin/env bash
# Data-parallel training launcher of the PyTorch port (after
# tools/dist_train.sh): torchrun starts one process per card on this host,
# each running tools_torch/train.py --distributed, which joins the group
# from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
# MASTER_PORT), takes cuda:LOCAL_RANK and averages the gradients with one
# all-reduce per step (NCCL by default; --dist-backend gloo for the CPU
# or ranks that share a card). --batch-size is the global batch.
#
# The JAX launcher runs one identical process per host that calls
# jax.distributed.initialize() (train.py --multihost), the coordinator
# from the TPU metadata or JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
# JAX_PROCESS_ID. Here each host runs NPROC processes (default: one per
# card, torchrun's "gpu"; set NPROC for the CPU). For several hosts run this
# on every host with torchrun's rendezvous in TORCHRUN_ARGS, e.g.
# TORCHRUN_ARGS="--nnodes 2 --node_rank K --master_addr host0
# --master_port 29500": JAX_COORDINATOR_ADDRESS maps to --master_addr and
# --master_port, JAX_NUM_PROCESSES to --nnodes (times NPROC processes),
# JAX_PROCESS_ID to --node_rank. Without TORCHRUN_ARGS it runs --standalone
# on this host.
#
# Usage: [NPROC=n] ./tools_torch/dist_train.sh <config> <work_dir> \
#            --train-ann <ann.json> --train-img <dir> [extra train.py args...]
set -euo pipefail

CONFIG=${1:?usage: dist_train.sh <config> <work_dir> [args...]}
WORK_DIR=${2:?usage: dist_train.sh <config> <work_dir> [args...]}
shift 2

# shellcheck disable=SC2086  # TORCHRUN_ARGS is a list of options
exec "${PYTHON:-python3}" -m torch.distributed.run ${TORCHRUN_ARGS:---standalone} \
    --nproc_per_node "${NPROC:-gpu}" "$(dirname "$0")/train.py" \
    --config "$CONFIG" --work-dir "$WORK_DIR" --distributed "$@"
