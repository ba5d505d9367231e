"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on one H100.

One command runs one cell once:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: ``BENCHMARK.json`` at the
root lists the cells and metrics, ``workloads/<cell>.json`` holds a cell's
traffic and limits, ``configs/<config>.json`` its model's sizes,
``drivers/<kind>.py`` drives the program for one kind of traffic,
``traffic/<kind>.py`` draws that traffic from the seed,
``refs/<config>.py`` is the model's plain float32 reference,
``costs/`` the frozen closed forms of operations and bytes and the peaks,
``metrics/<metric>.py`` reads one per-layer metric. See README.md.
"""
