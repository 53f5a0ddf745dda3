"""Multi-device layer (counterpart of lc_crf_slam_tpu/parallel/): process
groups and meshes (`mesh`), bundle adjustment over sharded edges or point
blocks (`dist_ba`), and the CRF over sharded tracks (`dist_crf`)."""
