from gfx_ocean_tpu_torch.cli import main

raise SystemExit(main())
