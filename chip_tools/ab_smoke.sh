#!/bin/bash
# Two checkouts' chip_smoke.py in turns on one card (A, B, B, A), then B's
# chip_tools/k1_leg_ab.py against each checkout in the same turns (K1's
# whole device leg as each checkout's engine runs it), then the card tests
# of B. Run from the repository's root:
#
#   git archive <parent> | tar -x -C build/ab/parent   # and B likewise
#   bash chip_tools/ab_smoke.sh build/ab/parent build/ab/final
#
# Each run's output goes to chiprun_out/ab_<n>_<name>.log (the leg's to
# ab_leg_<n>_<name>.log); the card's name and power limit to
# chiprun_out/ab_card.txt, exit codes to ab_summary.txt.
set -u
a=$1
b=$2
out=$PWD/chiprun_out
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/ab_card.txt"
i=0
for dir in "$a" "$b" "$b" "$a"; do
  i=$((i + 1))
  name=$(basename "$dir")
  (cd "$dir" && timeout 420 python3 chip_smoke.py > "$out/ab_${i}_${name}.log" 2>&1)
  echo "run $i $name rc=$?" | tee -a "$out/ab_summary.txt"
done
leg=$(cd "$b" && pwd)/chip_tools/k1_leg_ab.py
i=0
for dir in "$a" "$b" "$b" "$a"; do
  i=$((i + 1))
  name=$(basename "$dir")
  timeout 300 python3 "$leg" --root "$dir" > "$out/ab_leg_${i}_${name}.log" 2>&1
  echo "leg run $i $name rc=$?" | tee -a "$out/ab_summary.txt"
  grep "^k1_leg_ab .* rows" "$out/ab_leg_${i}_${name}.log"
done
(cd "$b" && timeout 300 python3 -m pytest -p no:cacheprovider tests/test_torch_cuda.py -q \
  > "$out/ab_cuda_tests.log" 2>&1)
echo "cuda tests rc=$?" | tee -a "$out/ab_summary.txt"
tail -3 "$out/ab_cuda_tests.log"
