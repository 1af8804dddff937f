"""``python -m repro_torch.tuning`` — the autotuner CLI (see autotune.py)."""
from repro_torch.tuning.autotune import main

if __name__ == "__main__":
    main()
