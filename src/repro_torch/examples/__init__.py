"""The repo's seven example scripts (``examples/*.py``) on the port, one
module each under the script's name, so that they run on the card:

  PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

``quickstart`` (train a smoke model), ``serve_batch`` (the engine on the
banked KV pool), ``long_context_decode`` (mamba2's constant state),
``memory_sim_sweep`` (Fig. 4 and the §II-A banking comparator),
``adas_scenarios`` (the scenario DSL swept as one batch), ``qos_isolation``
(three QoS points and ``interference_report``) and ``slice_scaling`` (a
2-slice fabric, local against remote).  Each keeps its script's arguments,
defaults, sizes, asserts and printed text, and adds ``--device`` (default:
the CUDA card, raising where there is none).  Each module's ``run(*,
device=None, **sizes)`` returns what the script prints as a dict,
``text(result)`` is the printed text, ``check(result)`` the script's
asserts, and ``main(argv=None)`` runs all three.  ``repro_torch.data.
EXAMPLES`` holds each one's sizes.
"""

#: the modules, in the order ``chip_smoke.py`` runs them
NAMES = (
    "memory_sim_sweep",
    "adas_scenarios",
    "qos_isolation",
    "slice_scaling",
    "serve_batch",
    "quickstart",
    "long_context_decode",
)


def device_arg(ap) -> None:
    """The ``--device`` option every example adds to its script's."""
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
