"""Joint PPT class vocabulary across Structured3D / ScanNet / S3DIS.

Benchmark-defined constant tables, verbatim from the reference PPT configs
(reference configs/scannet/semseg-ppt-v1m1-0-sc-s3-st-spunet-lovasz-ft.py
``class_name``/``valid_index``; identical in the pretrain and insseg configs).
The CLIP text head classifies against embeddings of these exact strings, so
both the ordering and the spelling (including the reference's trailing space
in "other structure ") must be reproduced bit-for-bit for checkpoint parity.
"""

PPT_CONDITIONS = ("Structured3D", "ScanNet", "S3DIS")

PPT_CLASS_NAMES = (
    "wall",
    "floor",
    "cabinet",
    "bed",
    "chair",
    "sofa",
    "table",
    "door",
    "window",
    "bookshelf",
    "bookcase",
    "picture",
    "counter",
    "desk",
    "shelves",
    "curtain",
    "dresser",
    "pillow",
    "mirror",
    "ceiling",
    "refrigerator",
    "television",
    "shower curtain",
    "nightstand",
    "toilet",
    "sink",
    "lamp",
    "bathtub",
    "garbagebin",
    "board",
    "beam",
    "column",
    "clutter",
    "other structure ",  # sic — trailing space as in the reference prompt
    "other furniture",
    "other property",
)

# per-dataset indices into PPT_CLASS_NAMES, ordered as PPT_CONDITIONS
PPT_VALID_INDEX = (
    # Structured3D (25)
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 23,
     25, 26, 33, 34, 35),
    # ScanNet (20)
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 15, 20, 22, 24, 25, 27, 34),
    # S3DIS (13)
    (0, 1, 4, 5, 6, 7, 8, 10, 19, 29, 30, 31, 32),
)

# the insseg-ppt fine-tune configs use a slightly different spelling of the
# last three classes (reference configs/scannet/insseg-ppt-...-ft.py)
PPT_CLASS_NAMES_INSSEG = PPT_CLASS_NAMES[:33] + (
    "otherstructure",
    "otherfurniture",
    "otherprop",
)
