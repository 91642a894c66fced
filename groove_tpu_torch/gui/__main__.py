from groove_tpu_torch.gui.tui import main

if __name__ == "__main__":
    raise SystemExit(main())
