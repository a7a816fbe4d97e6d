from kaito_tpu_torch.ui import main

if __name__ == "__main__":
    main()
