"""Import modules of the port."""

import torch


def start_on_the_card(importer) -> None:
    """``importer.start`` on the card where its caller chose no device
    (``importer._device`` is None), as the importers that decode on the
    device do before their first batch; raises when there is no card, as
    the CLI's ``--device cuda`` does."""
    if importer._device is not None:
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"{type(importer).__name__}: no CUDA device is "
                           "available (call start(torch.device('cpu')) to "
                           "decode with the plain versions)")
    importer.start(torch.device("cuda"))
