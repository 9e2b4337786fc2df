#!/bin/bash
# SLURM resource headers (honored when submitted with sbatch, inert when run
# directly): one host with one NVIDIA GPU, CPU workers for datagen and IO
# (the reference's sbatch.sh:1-12 GPU request).
#SBATCH --gres=gpu:1
#SBATCH --ntasks-per-node=1
#SBATCH --cpus-per-task=8
#SBATCH --mem=32G
#SBATCH --time=20:00:00
#SBATCH --output=job_logs/out_%x_%j.log
#
# Staged experiment launcher of the PyTorch / CUDA port (the counterpart of
# the root launch.sh): runs any combination of the generate_data / train /
# inference / evaluate / compare stages for one experiment, each through
# `python -m porous_cfd_tpu_torch.run_experiment`, in the order given.
#
# Usage:
#   porous_cfd_tpu_torch/launch.sh -x <experiment> [-g "<generate args>"]
#       [-t "<train args>"] [-i "<inference args>"] [-e "<evaluate args>"]
#       [-c "<compare args>"]
# Example:
#   porous_cfd_tpu_torch/launch.sh -x duct_fixed_boundary \
#       -g "--openfoam-dir /usr/bin/openfoam2412 --openfoam-procs 8" \
#       -t "--model pipn --name pipn-run --epochs 3000 --n-internal 1500 --n-boundary 1000 --n-observations 700 --train-dir data/train --val-dir data/val" \
#       -e "--checkpoint lightning_logs/pipn-run/model.ckpt --data-dir data/test --meta-dir data/train"
set -e

REPO_DIR="$(cd "$(dirname "$0")/.." && pwd)"
EXPERIMENT=""
declare -A STAGE_ARGS
RUN_STAGES=()

while getopts "x:g:t:i:e:c:" opt; do
  case $opt in
    x) EXPERIMENT="$OPTARG" ;;
    g) RUN_STAGES+=("generate_data"); STAGE_ARGS[generate_data]="$OPTARG" ;;
    t) RUN_STAGES+=("train");         STAGE_ARGS[train]="$OPTARG" ;;
    i) RUN_STAGES+=("inference");     STAGE_ARGS[inference]="$OPTARG" ;;
    e) RUN_STAGES+=("evaluate");      STAGE_ARGS[evaluate]="$OPTARG" ;;
    c) RUN_STAGES+=("compare");       STAGE_ARGS[compare]="$OPTARG" ;;
    *) echo "unknown option"; exit 1 ;;
  esac
done

if [ -z "$EXPERIMENT" ]; then
  echo "usage: $0 -x <experiment> [-g|-t|-i|-e|-c \"args\"]"
  exit 1
fi

export PYTHONPATH="$REPO_DIR${PYTHONPATH:+:$PYTHONPATH}"

for stage in "${RUN_STAGES[@]}"; do
  echo "=== $EXPERIMENT :: $stage ${STAGE_ARGS[$stage]}"
  # shellcheck disable=SC2086
  EXPERIMENT="$EXPERIMENT" RUNCMD="$stage" \
    python -m porous_cfd_tpu_torch.run_experiment ${STAGE_ARGS[$stage]}
done
