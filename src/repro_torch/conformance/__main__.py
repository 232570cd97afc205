"""``python -m repro_torch.conformance --arch granite-8b --devices 4``"""
from .matrix import main

raise SystemExit(main())
