#!/usr/bin/env bash
# Data-parallel evaluation launcher of the PyTorch port (after
# tools/dist_test.sh): tools_torch/test.py --chips N starts N local ranks
# itself (rank r on cuda:r mod the card count, each with --batch-size / N
# images per batch; NCCL by default, --dist-backend gloo for the CPU or
# ranks that share a card); the ranks run every N-th batch and gather the
# detections, rank 0 prints the metrics and writes the dumps (the
# reference's multi_gpu_test).
#
# The JAX launcher maps N local chips to a 'data' mesh in one process,
# and several hosts to one process each that calls
# jax.distributed.initialize(). Across hosts here, run tools_torch/test.py
# --distributed under torchrun on every host instead (see dist_train.sh
# for how JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID map
# to torchrun's options).
#
# Usage: ./tools_torch/dist_test.sh <config> <checkpoint> <n_chips> [extra test.py args...]
set -euo pipefail

CONFIG=${1:?usage: dist_test.sh <config> <checkpoint> <n_chips> [args...]}
CHECKPOINT=${2:?usage: dist_test.sh <config> <checkpoint> <n_chips> [args...]}
CHIPS=${3:?usage: dist_test.sh <config> <checkpoint> <n_chips> [args...]}
shift 3

exec "${PYTHON:-python3}" "$(dirname "$0")/test.py" \
    --config "$CONFIG" --checkpoint "$CHECKPOINT" --chips "$CHIPS" "$@"
