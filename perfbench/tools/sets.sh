# The measurements behind a cell's bounds and limits, in one call:
#   bash perfbench/tools/sets.sh <output directory> <workload> \
#       <6 seeds of the two sets> <3 traced seeds> <3 more seeds>
# two sets of 6 timed runs on the same seeds, 3 traced runs, and 3 short
# runs on further seeds for the comparison's readings.
S="python3 -m perfbench.tools.series --out $1"
W=$2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
$S --workload $W --seconds 51 --seeds $3 $4 $5 $6 $7 $8 --timeout 360
$S --workload $W --seconds 51 --seeds $3 $4 $5 $6 $7 $8 --timeout 360
$S --workload $W --seconds 51 --trace 1 --seeds $9 ${10} ${11} --timeout 360
$S --workload $W --seconds 5 --seeds ${12} ${13} ${14} --timeout 360
