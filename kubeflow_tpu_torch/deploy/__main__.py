"""`python -m kubeflow_tpu_torch.deploy [profile] [--image IMG]` ->
multi-document YAML on stdout (the `kustomize build
config/overlays/{profile}` analog)."""

import argparse
from typing import Optional

from .manifests import DEFAULT_IMAGE, PROFILES, render_yaml


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="kubeflow_tpu_torch.deploy")
    parser.add_argument("profile", nargs="?", default="standalone",
                        choices=sorted(PROFILES))
    parser.add_argument("--image", default=DEFAULT_IMAGE,
                        help="manager container image")
    args = parser.parse_args(argv)
    print(render_yaml(args.profile, image=args.image), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
