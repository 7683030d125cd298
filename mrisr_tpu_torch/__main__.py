"""``python -m mrisr_tpu_torch`` -> the CLI."""

from mrisr_tpu_torch.cli import main

if __name__ == "__main__":
    main()
