"""``python -m repro_torch.obs FILE...`` — the metrics schema gate."""
from .metrics import main

raise SystemExit(main())
