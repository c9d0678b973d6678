"""``python -m volcano_tpu_torch.bench``: the port's benchmark
(volcano_tpu_torch/bench/run.py)."""

import sys

from volcano_tpu_torch.bench.run import main

sys.exit(main())
