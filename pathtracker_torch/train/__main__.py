"""``python -m pathtracker_torch.train <flags>``: the training CLI
(pathtracker_tpu/train/__main__.py); the flags are utils/opts.py's."""

from pathtracker_torch.train.loop import main

if __name__ == "__main__":
    main()
