#!/bin/bash
# The serve-and-learn excursion experiment (exp_learn_excursion.py) against
# two checkouts in one call, in the order parent, change, change, parent:
#
#   kmeans_tpu_torch/experiments/exp_learn_excursion_ab.sh PARENT [reps] [variants] [tag]
#
# Run from the root of the change's checkout.  PARENT is a checkout of the
# parent commit (for example `git archive` of it unpacked into a directory
# that .gitignore lists).  Each run writes chiprun_out/pr<tag>_<i>_<tree>.json.
# Needs one CUDA device.
set -u
parent=$(cd "$1" && pwd)
change=$(pwd)
reps=${2:-15}
variants=${3:-update,sleep}
tag=${4:-ab}
i=0
for tree in parent change change parent; do
  i=$((i + 1))
  if [ "$tree" = parent ]; then root=$parent; else root=$change; fi
  echo "== run $i tree $tree"
  PYTHONPATH=$root python "$change/kmeans_tpu_torch/experiments/exp_learn_excursion.py" \
    "$reps" "chiprun_out/pr${tag}_${i}_${tree}.json" "$variants" 2>&1 \
    | grep -v "^Iteration\|^Starting\|^SSE" | cut -c1-600
done
