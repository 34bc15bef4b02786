from sfm_tpu_torch.ops import (ba, descriptors, epipolar, features,  # noqa: F401
                               image, klt, lie, linalg, orb, pnp, posegraph,
                               triangulate, umeyama)
