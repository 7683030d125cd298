"""Data layer: DICOM ingest (zip extractor ``extract.py``, cleaner
``clean.py``, series discovery ``discovery.py`` on the dependency-free
reader/writer ``dicom_lite.py`` and its native header scanner
``dicom_fast.py``), export of predictions to DICOM (``export.py``), the
packed volume store, patient split, triplet/window index math, synthetic
phantoms and the loaders that feed the card."""

from mrisr_tpu_torch.data.synthetic import (  # noqa: F401
    make_synthetic_store,
    make_synthetic_volume,
)
from mrisr_tpu_torch.data.triplets import (  # noqa: F401
    TripletIndex,
    WindowIndex,
    num_triplets,
    triplet_slice_ids,
)
from mrisr_tpu_torch.data.volumes import VolumeStore  # noqa: F401
