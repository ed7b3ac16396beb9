"""Known methods that live in other repositories (torch port of
`neurad_tpu/configs/external_methods.py`): asking for one by name gives its
install instructions instead of an unknown-method error. Once installed, such
a method registers itself through `neurad_tpu_torch.plugins.registry`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ExternalMethod:
    instructions: str  # printed when the method is asked for
    configurations: List[Tuple[str, str]]  # (name, description)
    pip_package: Optional[str] = None


external_methods: List[ExternalMethod] = [
    ExternalMethod(
        instructions=(
            "UniSim is an external method. Install it first:\n"
            "  pip install git+https://github.com/carlinds/unisim\n"
            "then re-run with the same method name (its plugin entry point registers it)."
        ),
        configurations=[
            ("unisim", "UniSim reproduction, as specified in the paper"),
            ("unisim++", "UniSim with some improvements/tweaks"),
        ],
        pip_package="git+https://github.com/carlinds/unisim",
    ),
]


def get_external_methods() -> Dict[str, ExternalMethod]:
    """name -> ExternalMethod of every configuration listed above."""
    return {slug: method for method in external_methods for slug, _ in method.configurations}
