#!/bin/bash
# Scene-generalization eval: score the aug-trained
# checkpoint against a val sequence rendered from an UNSEEN world
# (world_seed=1) — same trajectory family, different scene content.
# Store built by: RSLO_PROXY_ROOT=/tmp/rslo_proxy_gen \
#   accuracy_proxy.py build --seqs 7 --world_seed 1  (+ create_hdf5 -s 7)
# Usage: bash scripts/eval_gen_world.sh [middle] [ckpt_step]
set -ex
cd /root/repo
MIDDLE=${1:-PillarMiddleCov}
CKPT=${2:-best}
GEN=/tmp/rslo_proxy_gen
mkdir -p "$GEN"
[ -f "$GEN/proxy.h5" ] || \
  cp .proxy_store/gen_world/proxy.h5 .proxy_store/gen_world/gt_poses_7.npz "$GEN/"
# same checkpoint, new world: copy the trained model dir into the root
rm -rf "$GEN/model_${MIDDLE}_aug"
cp -r "/tmp/rslo_proxy/model_${MIDDLE}_aug" "$GEN/" 2>/dev/null || \
  cp -r ".proxy_store/model_${MIDDLE}_aug" "$GEN/"
RSLO_PROXY_ROOT="$GEN" python -u scripts/accuracy_proxy.py \
  eval --middle "$MIDDLE" --tag aug --ckpt_step "$CKPT"
RSLO_PROXY_ROOT="$GEN" python scripts/accuracy_proxy.py report
