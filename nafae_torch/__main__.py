"""Top-level CLI dispatcher:
python -m nafae_torch {train,eval,extract,convert,visualize,serve} [args...]
(the port of `nafae_tpu/__main__.py`). Exits with the command's code; 2
with the usage line for an unknown or missing command."""

import importlib
import sys

COMMANDS = {
    "train": "nafae_torch.train",
    "eval": "nafae_torch.evaluate",
    "extract": "nafae_torch.extract",
    "convert": "nafae_torch.utils.torch_convert",
    "visualize": "nafae_torch.visualize",
    "serve": "nafae_torch.serve",
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m nafae_torch {{{','.join(COMMANDS)}}} "
              "[args...]", file=sys.stderr)
        return 2
    return importlib.import_module(COMMANDS[argv[0]]).main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
